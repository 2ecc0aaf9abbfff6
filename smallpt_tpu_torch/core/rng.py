"""Stateless, placement-invariant random number streams (PyTorch port of
smallpt_tpu/core/rng.py).

Every random decision is keyed by its coordinates in the computation:

    (seed) -> sample_id -> path history -> depth -> purpose lane

so a lane's uniforms do not depend on where it runs. Two generators:

- the per-pass key is a threefry2x32 key, as ``jax.random.PRNGKey`` and
  ``jax.random.fold_in`` make it. ``base_key``/``fold_in`` below compute the
  same two uint32 words with numpy, so a seed gives the JAX package's keys
  without JAX (``base_key(7) == [0, 7]``,
  ``fold_in(base_key(0), 3) == [2467461003, 3840466878]``);
- the per-lane expansion is PCG4D (Jarzynski & Olano, JCGT 2020), which must
  give the JAX package's bits, so it is written out here and not taken from
  ``torch.Generator``.

torch on the CPU has no ``>>`` for uint32, so the tensor PCG4D works in
int64 holding values in [0, 2^32), masked after every step; products are
split into 16-bit halves so that no intermediate leaves int64's range. The
CUDA kernel (csrc/megakernel.cu) does the same arithmetic in native
``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

_CAMERA_SALT = 0x9E3779B9
# distinct from _CAMERA_SALT: with equal salts the (sid, hist=0, depth=0)
# shade tuple equals the camera tuple (correlated sampling)
_GOLDEN = 0x85EBCA6B
_LENS_SALT = 0x94D049BB
_NEE_SALT = 0x2545F491
_STREAM_IP_MULT = 0x9E3779B1
STREAM_KEY_VERSION = 2
_NEE_SLOT_STRIDE = 0x632BE59B

_MASK = 0xFFFFFFFF
_PCG_MUL = 1664525
_PCG_INC = 1013904223


# -- threefry2x32 keys (jax.random.PRNGKey / fold_in, default impl) ---------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds on one counter pair (Salmon et al.,
    SC'11), in the round and key-schedule order of jax's threefry2x32."""
    m = _MASK
    ks = (k0 & m, k1 & m, (k0 ^ k1 ^ 0x1BD11BDA) & m)
    x = [(x0 + ks[0]) & m, (x1 + ks[1]) & m]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & m
            x[1] = ((x[1] << r) | (x[1] >> (32 - r))) & m
            x[1] ^= x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & m
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & m
    return x[0], x[1]


def base_key(seed: int) -> np.ndarray:
    """(2,) uint32 key words of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """(2,) uint32 key words of ``jax.random.fold_in(key, data)``."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return np.array(
        _threefry2x32(int(k[0]), int(k[1]), 0, int(data) & _MASK), np.uint32
    )


def key_words(key) -> tuple[int, int]:
    """The two key words as Python ints (accepts a (2,) array or a pair)."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return int(k[0]), int(k[1])


# -- PCG4D on int64 tensors ---------------------------------------------------


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors (or an int b) holding uint32
    values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _pcg4d(a, b, c, d):
    """PCG4D mix (Jarzynski & Olano 2020, listing 4): LCG step per lane,
    two rounds of cross-lane feedback, one xorshift. uint32 wrapping
    arithmetic on int64 tensors holding values in [0, 2^32)."""
    m = _MASK
    a = (_mul32(a, _PCG_MUL) + _PCG_INC) & m
    b = (_mul32(b, _PCG_MUL) + _PCG_INC) & m
    c = (_mul32(c, _PCG_MUL) + _PCG_INC) & m
    d = (_mul32(d, _PCG_MUL) + _PCG_INC) & m
    a = (a + _mul32(b, d)) & m
    b = (b + _mul32(c, a)) & m
    c = (c + _mul32(a, b)) & m
    d = (d + _mul32(b, c)) & m
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & m
    b = (b + _mul32(c, a)) & m
    c = (c + _mul32(a, b)) & m
    d = (d + _mul32(b, c)) & m
    return a, b, c, d


def _to_unit(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 (held in int64) -> [0, 1) float with 24 random mantissa bits."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """int tensor or Python int -> int64 tensor (shaped like ``like``) of
    its uint32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.full_like(like, int(x) & _MASK, dtype=torch.int64)


def _keyed(key, sample_ids, word_b, word_c):
    """PCG4D of (sid ^ k0, word_b, word_c, k0 + k1) — the shared tuple of
    the per-pass camera, lens and shade streams."""
    k0, k1 = key_words(key)
    sid = _u32(sample_ids, sample_ids)
    return _pcg4d(sid ^ k0, _u32(word_b, sid), _u32(word_c, sid),
                  _u32(k0 + k1, sid))


def camera_uniforms(key, sample_ids: torch.Tensor, dtype=torch.float32):
    """(N, 2) uniforms for the pixel filter, keyed per global sample id."""
    a, b, _, _ = _keyed(key, sample_ids, key_words(key)[1], _CAMERA_SALT)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)


def lens_uniforms(key, sample_ids: torch.Tensor, dtype=torch.float32):
    """(N, 2) uniforms for the thin-lens aperture sample, keyed per global
    sample id (depth of field; RenderConfig.aperture)."""
    a, b, _, _ = _keyed(key, sample_ids, key_words(key)[1], _LENS_SALT)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)


def shade_uniforms(key, sample_ids: torch.Tensor, hist: torch.Tensor,
                   depth: torch.Tensor, dtype=torch.float32):
    """(N, 4) uniforms [rr, bsdf_u1, bsdf_u2, refr_choice] for one shading
    event per lane, keyed by the event's coordinates (sample, split-tree
    position, bounce depth)."""
    k1 = key_words(key)[1]
    a, b, c, d = _keyed(key, sample_ids, _u32(hist, hist) ^ k1,
                        (_u32(depth, depth) + _GOLDEN) & _MASK)
    return torch.stack(
        [_to_unit(a, dtype), _to_unit(b, dtype), _to_unit(c, dtype),
         _to_unit(d, dtype)],
        dim=-1,
    )


def nee_uniforms(key, sample_ids: torch.Tensor, hist: torch.Tensor,
                 depth: torch.Tensor, light_slot: int, dtype=torch.float32):
    """(N, 2) uniforms for next-event estimation's light-cone sample at one
    shading event, one pair per sampled light. The c-word is
    depth + _NEE_SALT + light_slot * _NEE_SLOT_STRIDE."""
    k1 = key_words(key)[1]
    a, b, _, _ = _keyed(key, sample_ids, _u32(hist, hist) ^ k1,
                        (_u32(depth, depth) + _nee_salt(light_slot)) & _MASK)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)


def _nee_salt(light_slot: int) -> int:
    """The NEE c-word offset of one light slot: a bare ``+ slot`` would
    alias slot s+1 at depth d with slot s at depth d+1."""
    return (_NEE_SALT + light_slot * _NEE_SLOT_STRIDE) & _MASK


# -- streaming keying (v2) ----------------------------------------------------
#
# The streaming kernel keys a sample by (pixel, ip) as two separate PCG4D
# words: a = pixel ^ k0, b = k1 ^ (ip * _STREAM_IP_MULT) (odd, so injective
# in ip). Streams stay unique for any ip < 2^32 at any resolution; v1 packed
# pixel + n_pixels * ip into one word and wrapped inside real budgets.


def stream_key_words(key, pixel: torch.Tensor, ip: torch.Tensor):
    """(a, b) PCG4D input words of the streaming samples (pixel, ip), as
    int64 tensors holding uint32 values."""
    k0, k1 = key_words(key)
    a = _u32(pixel, pixel) ^ k0
    b = _mul32(_u32(ip, ip), _STREAM_IP_MULT) ^ k1
    return a, b


def _stream_keyed(key, pixel, ip, word_c):
    k0, k1 = key_words(key)
    a, b = stream_key_words(key, pixel, ip)
    return _pcg4d(a, b, _u32(word_c, a), _u32(k0 + k1, a))


def stream_camera_uniforms(key, pixel: torch.Tensor, ip: torch.Tensor,
                           dtype=torch.float32):
    """(N, 2) pixel-filter uniforms of the streaming samples (pixel, ip)."""
    a, b, _, _ = _stream_keyed(key, pixel, ip, _CAMERA_SALT)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)


def stream_lens_uniforms(key, pixel: torch.Tensor, ip: torch.Tensor,
                         dtype=torch.float32):
    """(N, 2) thin-lens aperture uniforms of the streaming samples."""
    a, b, _, _ = _stream_keyed(key, pixel, ip, _LENS_SALT)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)


def stream_shade_uniforms(key, pixel: torch.Tensor, ip: torch.Tensor,
                          depth: torch.Tensor, dtype=torch.float32):
    """(N, 4) per-bounce shade uniforms [rr, bsdf_u1, bsdf_u2, refr_choice]
    of the streaming samples; streaming paths never split, so there is no
    history word."""
    a, b, c, d = _stream_keyed(key, pixel, ip,
                               (_u32(depth, depth) + _GOLDEN) & _MASK)
    return torch.stack(
        [_to_unit(a, dtype), _to_unit(b, dtype), _to_unit(c, dtype),
         _to_unit(d, dtype)],
        dim=-1,
    )


def stream_nee_uniforms(key, pixel: torch.Tensor, ip: torch.Tensor,
                        depth: torch.Tensor, light_slot: int,
                        dtype=torch.float32):
    """(N, 2) light-cone uniforms of one NEE light slot for the streaming
    samples at a bounce depth."""
    a, b, _, _ = _stream_keyed(
        key, pixel, ip, (_u32(depth, depth) + _nee_salt(light_slot)) & _MASK)
    return torch.stack([_to_unit(a, dtype), _to_unit(b, dtype)], dim=-1)
