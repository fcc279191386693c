import sys

from fermat_tpu_torch.utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
