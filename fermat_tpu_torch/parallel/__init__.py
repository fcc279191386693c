"""Multi-device rendering over torch.distributed (fermat_tpu/parallel)."""
