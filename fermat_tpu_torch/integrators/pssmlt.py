"""Primary-sample-space Metropolis light transport, Kelemen PSSMLT
(fermat_tpu/integrators/pssmlt.py).

Chains are lanes: each holds a primary-sample vector u (D,) that a
MatrixSequence feeds to the path evaluator in place of the QMC sampler.
`path_space="bpt"` (the default) evaluates a chain's full bidirectional path
set through the BPT pass: its eye-strategy radiance plus every light-tracing
splat, carried as K = max_path_length (pixel, rgb) slots through
accept/reject; `path_space="pt"` evaluates one PT path (rr=False). init_state
seeds the chains by luminance-weighted reservoir resampling over
n_seed_candidates rounds and estimates the image brightness b; each step
mutates every chain (a large step with probability large_step_prob, else a
symmetric exponential small step in every dimension), re-traces, and splats
both the current and the proposed path sets at their expected-value weights
with `index_add_` before the Metropolis accept/reject.

The uint32 hashes follow core/rng.py: int64 tensors (or Python ints, the
chain key) masked to 32 bits. JAX's splat scatters with mode="drop", but a
negative index wraps before the drop applies, so the -1 slots of a path set
land on the last pixel, H*W-1 (their rgb is zero unless a throughput was
infinite); the port adds them there too.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fermat_tpu_torch.core.rng import M32, hash_combine, uniform_from_bits
from fermat_tpu_torch.integrators import bpt as bpt_mod
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor


class MatrixSequence(NamedTuple):
    """Sampler over an explicit (N, D) primary-sample matrix: dimension d of
    lane i reads u[i, d], d clipped to D-1 (pssmlt.py:40-60). The pixel
    argument is ignored; dimensions are Python ints."""

    u: Tensor  # (N, D)

    def _col(self, dim: int) -> Tensor:
        return self.u[:, min(max(int(dim), 0), self.u.shape[1] - 1)].contiguous()

    def sample_1d(self, pix, dim):
        return self._col(dim)

    def sample_2d(self, pix, dim):
        return self._col(dim), self._col(dim + 1)

    def sample_3d(self, pix, dim):
        return self._col(dim), self._col(dim + 1), self._col(dim + 2)


class PssmltOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's PssmltOptions (pssmlt.py:63-73);
    one chain per pixel lane."""

    max_path_length: int = 6
    large_step_prob: float = 0.3  # independent-mutation mixture weight
    small_step_size: float = 1.0 / 64.0  # exp-step scale (Kelemen s2)
    n_seed_candidates: int = 4  # seeding oversampling factor
    tracer: str = "auto"
    path_space: str = "bpt"  # "bpt" | "pt"


class PssmltState(NamedTuple):
    u: Tensor  # (N, D) current primary vectors
    i_lum: Tensor  # (N,) current path-set total luminance
    contrib: Tensor  # (N, K, 3) current contribution set
    pixel: Tensor  # (N, K) int32 pixel ids, -1 = empty slot
    brightness: Tensor  # () normalization b
    key: int  # uint32 counter of the mutation randomness


def _luminance(c: Tensor) -> Tensor:
    """(..., 3) -> (...,) luminance."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


# BPT's fixed QMC dimension layout tops out at 300 + (L-2) * dpb + 3 (its eye
# continuation); PSSMLT mutates the whole range (pssmlt.py:94-96)
_BPT_DIM_BASE = 304


def _dims(opts: PssmltOptions) -> int:
    dpb = pt_mod.PTOptions().dims_per_bounce
    if opts.path_space == "bpt":
        return _BPT_DIM_BASE + opts.max_path_length * dpb
    return 2 + opts.max_path_length * dpb


def _check(opts: PssmltOptions) -> None:
    if opts.path_space not in ("bpt", "pt"):
        raise NotImplementedError(
            f"PssmltOptions.path_space={opts.path_space!r}: the choices are ('bpt', 'pt')")


def _counter(n: int, d: int, device) -> Tensor:
    """(N, D) uint32 counters i * D + j."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    j = torch.arange(d, dtype=torch.int64, device=device)
    return (i[:, None] * d + j[None, :]) & M32


def _eval_paths(view: SceneView, opts: PssmltOptions, res_x: int, res_y: int,
                u: Tensor) -> Tuple[Tensor, Tensor]:
    """Trace the path sets of the primary vectors u (pssmlt.py:110-154).
    Returns (contrib (N, K, 3), pixel (N, K) int32, -1 = empty slot)."""
    # dimensions 0 and 1 choose the image point: the pixel and its jitter
    px = torch.clamp((u[:, 0] * res_x).to(torch.int32), 0, res_x - 1)
    py = torch.clamp((u[:, 1] * res_y).to(torch.int32), 0, res_y - 1)
    pixel = (py * res_x + px).to(torch.int64)
    u_mod = u.clone()
    u_mod[:, 0] = u[:, 0] * res_x - px
    u_mod[:, 1] = u[:, 1] * res_y - py
    seq = MatrixSequence(u_mod)
    if opts.path_space == "bpt":
        bopts = bpt_mod.BPTOptions(max_path_length=opts.max_path_length, tracer=opts.tracer)
        rad, _, _, _, sp, sr = bpt_mod.render_pass(view, bopts, res_x, res_y, 0, pix=pixel,
                                                   sequence=seq, return_splat_list=True)
        contrib = torch.cat([rad.stack()[:, None, :], sr], dim=1)
        return contrib, torch.cat([pixel.to(torch.int32)[:, None], sp], dim=1)
    popts = pt_mod.PTOptions(max_path_length=opts.max_path_length, rr=False, tracer=opts.tracer)
    out = pt_mod.render_pass(view, popts, res_x, res_y, 0, pix=pixel, sequence=seq)
    return out.composited.stack()[:, None, :], pixel.to(torch.int32)[:, None]


def init_state(view: SceneView, opts: PssmltOptions, res_x: int, res_y: int, n: int,
               seed: int = 0) -> PssmltState:
    """The seed pass (pssmlt.py:157-199): luminance-weighted reservoir
    resampling of chain seeds over n_seed_candidates rounds and the image
    brightness estimate."""
    _check(opts)
    dev = view.device
    d = _dims(opts)
    key0 = (seed * 2654435761 + 12345) & M32
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    ctr = _counter(n, d, dev)
    best_u = None
    best_lum = torch.full((n,), -1.0, device=dev)
    best_contrib = best_pixel = None
    total = torch.zeros((), device=dev)
    for c in range(opts.n_seed_candidates):
        u = uniform_from_bits(hash_combine(hash_combine(key0, c + 1), ctr))
        contrib, pixel = _eval_paths(view, opts, res_x, res_y, u)
        lum = _luminance(contrib).sum(dim=1)  # over the path set
        total = total + lum.mean()
        # keep the candidate with probability lum / (acc + lum)
        acc = torch.clamp_min(best_lum, 0.0) + lum
        r = uniform_from_bits(hash_combine(key0 ^ 0xABCD, hash_combine(c, lanes)))
        take = (best_lum < 0.0) | (r * acc < lum)
        if best_u is None:  # every lane takes its first candidate
            best_u, best_contrib, best_pixel = u, contrib, pixel
        else:
            best_u = torch.where(take[:, None], u, best_u)
            best_contrib = torch.where(take[:, None, None], contrib, best_contrib)
            best_pixel = torch.where(take[:, None], pixel, best_pixel)
        best_lum = torch.where(take, lum, torch.clamp_min(best_lum, 0.0))
    return PssmltState(u=best_u, i_lum=best_lum, contrib=best_contrib, pixel=best_pixel,
                       brightness=total / float(opts.n_seed_candidates),
                       key=key0 ^ 0x5BD1E995)


def _mutate(u: Tensor, key: int, opts: PssmltOptions) -> Tensor:
    """Kelemen mutation (pssmlt.py:202-222): a large step (fresh uniforms)
    with probability large_step_prob, else an exponential small step of
    either sign in every dimension, wrapped into [0, 1). The small step's
    scale shrinks as sqrt(50 / D) past 50 dimensions."""
    n, d = u.shape
    ctr = _counter(n, d, u.device)
    r1 = uniform_from_bits(hash_combine(key, ctr))
    r2 = uniform_from_bits(hash_combine(key ^ 0x9E3779B9, ctr))
    large = uniform_from_bits(hash_combine(key ^ 0x85EBCA6B,
                                           torch.arange(n, dtype=torch.int64, device=u.device)))
    is_large = (large < opts.large_step_prob)[:, None]
    s1 = 1.0 / 1024.0
    s2 = opts.small_step_size * min(1.0, (50.0 / d) ** 0.5)
    # JAX takes the log of the float32 ratio
    log_ratio = torch.log(torch.tensor(s2 / s1, dtype=torch.float32, device=u.device))
    mag = s2 * torch.exp(-log_ratio * r1)
    x = u + torch.where(r2 < 0.5, mag, -mag)
    rem = torch.fmod(x, 1.0)  # jnp.mod: the remainder taking the divisor's sign
    return torch.where(is_large, r1, torch.where(rem < 0.0, rem + 1.0, rem))


def _splat(img: Tensor, pixel: Tensor, rgb: Tensor) -> Tensor:
    """img[pixel] += rgb, a negative pixel wrapped as JAX wraps it."""
    p = pixel.reshape(-1).long()
    return img.index_add_(0, torch.where(p < 0, p + img.shape[0], p), rgb.reshape(-1, 3))


def step(view: SceneView, opts: PssmltOptions, res_x: int, res_y: int,
         state: PssmltState) -> Tuple[PssmltState, Tensor]:
    """One Metropolis step of every chain (pssmlt.py:225-266); returns (the
    new state, the (H*W, 3) splat image). The current path set splats with
    weight (1 - a) b / I, the proposal with a b / I', so that each chain
    adds b a step."""
    _check(opts)
    n = state.u.shape[0]
    key = hash_combine(state.key, 0x1234567)
    u_prop = _mutate(state.u, key, opts)
    contrib_p, pixel_p = _eval_paths(view, opts, res_x, res_y, u_prop)
    lum_p = _luminance(contrib_p).sum(dim=1)
    lum_c = torch.clamp_min(state.i_lum, 0.0)
    a = torch.clamp(lum_p / torch.clamp_min(lum_c, 1e-12), 0.0, 1.0)
    a = torch.where(lum_c <= 0.0, 1.0, a)
    b = state.brightness
    w_old = torch.where(lum_c > 0.0, (1.0 - a) * b / torch.clamp_min(lum_c, 1e-12), 0.0)
    w_new = torch.where(lum_p > 0.0, a * b / torch.clamp_min(lum_p, 1e-12), 0.0)
    splat = torch.zeros((res_x * res_y, 3), device=view.device)
    _splat(splat, state.pixel, state.contrib * w_old[:, None, None])
    _splat(splat, pixel_p, contrib_p * w_new[:, None, None])
    # chains-per-pixel normalization, a float32 ratio as JAX's
    scale = (torch.tensor(float(res_x * res_y), dtype=torch.float32)
             / torch.tensor(float(n), dtype=torch.float32))
    splat = splat * scale.to(splat.device)
    u_rng = uniform_from_bits(hash_combine(key ^ 0xC2B2AE35,
                                           torch.arange(n, dtype=torch.int64, device=view.device)))
    accept = u_rng < a
    new_state = PssmltState(
        u=torch.where(accept[:, None], u_prop, state.u),
        i_lum=torch.where(accept, lum_p, state.i_lum),
        contrib=torch.where(accept[:, None, None], contrib_p, state.contrib),
        pixel=torch.where(accept[:, None], pixel_p, state.pixel),
        brightness=state.brightness,
        key=hash_combine(key, 0xDEADBEEF),
    )
    return new_state, splat
