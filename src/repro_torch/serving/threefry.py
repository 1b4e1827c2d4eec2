"""The parts of `jax.random` the sampler and the data pipeline use, in
plain torch: the Threefry-2x32 counter hash, `PRNGKey`, `fold_in`,
`split`, `random_bits` in the partitionable layout, `uniform`, `normal`,
`bernoulli`, `gumbel` (mode "low") and `categorical`, each batched over a
leading axis of keys and computed on the device of its inputs.

Threefry-2x32 is 32-bit integer arithmetic, so the port draws from the
reference's own streams: keys, bits and uniforms equal JAX's bit for bit
(`tests/test_torch_sampler.py`).  Gumbel noise goes through `log`, whose
last bit differs between XLA and torch, so it matches to an ulp and a
categorical draw equals JAX's wherever the winner leads by more.

A 32-bit word is carried in an int64 tensor holding a value in
[0, 2^32): torch's uint32 has next to no CUDA arithmetic and its int32
right shift is arithmetic, while int64 holds every sum and shifted word
exactly before the mask brings it back to 32 bits.

A key is an (..., 2) int64 tensor of two such words.  JAX's layout with
`jax_enable_x64` off (the reference's setting): `PRNGKey(seed)` is
[0, seed mod 2^32] for any Python int seed, negative ones included.

The hash takes Python ints as well as tensors, so a key folded from ints
(the seed, a role) needs no host-to-device copy: a captured step may not
make one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def _word(x):
    """An int or an integer tensor -> its low 32 bits (an int, or an int64
    tensor)."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, on words (ints or broadcastable int64
    tensors) -> (y0, y1), as `jax.random`'s `threefry2x32_p`."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None):
    """`jax.random.PRNGKey(seed)` under 32-bit JAX -> (2,) int64 key."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_words(k1, k2, data):
    """`jax.random.fold_in` on key words (ints or tensors): data an int or
    an integer tensor, its low 32 bits taken as JAX's uint32 cast does
    -> (y0, y1)."""
    return threefry_2x32(k1, k2, 0, _word(data))


def key_tensor(k1, k2, device=None):
    """Key words (ints or broadcastable tensors) -> (..., 2) int64 key."""
    ts = [k for k in (k1, k2) if torch.is_tensor(k)]
    if not ts:
        return torch.tensor([k1, k2], dtype=torch.int64, device=device)
    like = torch.broadcast_tensors(*ts)[0]
    y = [k.expand_as(like) if torch.is_tensor(k) else torch.full_like(like, k)
         for k in (k1, k2)]
    return torch.stack(y, dim=-1)


def fold_in(key, data):
    """`jax.random.fold_in`: key (..., 2), data an int or an integer
    tensor broadcastable against key[..., 0] -> (..., 2) keys."""
    return key_tensor(*fold_words(key[..., 0], key[..., 1], data))


def _hash_counters(key, start: int, n: int):
    """The partitionable layout's hash of counters [start, start + n):
    counter i is the word pair (i >> 32, i & 0xFFFFFFFF).  key (..., 2)
    -> two (..., n) int64 words."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    return threefry_2x32(key[..., 0, None], key[..., 1, None],
                         i >> 32, i & MASK)


def split(key, num: int = 2):
    """`jax.random.split(key, num)`: key i keeps both words of counter
    i's hash.  key (..., 2) -> (..., num, 2)."""
    return torch.stack(_hash_counters(key, 0, num), dim=-1)


def random_bits(key, n: int, start: int = 0):
    """`jax.random.bits(key, shape, uint32)`, entries [start, start + n)
    of the flattened shape: the XOR of each counter's two hash words.
    key (..., 2) -> (..., n) int64 words."""
    y0, y1 = _hash_counters(key, start, n)
    return y0 ^ y1


def _unit_floats(bits):
    """Words -> f32 in [0, 1): 23 high bits as the mantissa of [1, 2),
    minus 1."""
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, n=None, minval: float = 0.0, maxval: float = 1.0,
            start: int = 0):
    """`jax.random.uniform(key, shape, float32, minval, maxval)` with shape
    (n,), or () when n is None, or entries [start, start + n) of a larger
    flattened shape: key (..., 2) -> (..., n) or (...) f32.
    f * (maxval - minval) + minval, floored at minval, with the one
    rounding of XLA's fused multiply-add: the product is exact in f64
    (24-bit factors), and when the f32 scale is 1 (the sampler's ranges)
    it is f itself."""
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = hi - lo
    f = _unit_floats(random_bits(key, 1 if n is None else n, start))
    if scale == 1.0:
        u = f + float(lo)
    else:
        u = (f.to(torch.float64) * float(scale) + float(lo)).to(
            torch.float32)
    u = torch.clamp_min(u, float(lo))
    return u[..., 0] if n is None else u


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's f32 erf_inv: a degree-8 polynomial in w - 2.5 (w < 5) or
# sqrt(w) - 3, w = -log1p(-x^2) (M. Giles, "Approximating the erfinv
# function"), highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """XLA's f32 erf_inv on x in (-1, 1), in its order; each Horner step
    c + p w is rounded once, as XLA contracts it into a fused
    multiply-add (the f64 product is exact).  Its log1p is ATen's, so a
    value may still differ from XLA's in the last bits."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).to(
        torch.float64)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, np.float32(a).item(), np.float32(b).item())
        p = (c.to(torch.float64) + p * w).to(torch.float32).to(torch.float64)
    return p.to(torch.float32) * x


def normal(key, shape):
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erf_inv(u), u
    uniform on [nextafter(-1, 0), 1), JAX's uniforms bit for bit; through
    `erf_inv` the normals agree with JAX's to a few ulp
    (`tests/test_torch_families.py` states the bound).  key (2,) -> f32
    tensor of `shape`."""
    u = uniform(key, math.prod(shape), _NORMAL_LO, 1.0)
    return (np.float32(np.sqrt(2.0)).item() * erf_inv(u)).reshape(shape)


def bernoulli(key, p: float, shape):
    """`jax.random.bernoulli(key, p, shape)` for a Python float p (mode
    "low"): uniform < p.  key (2,) -> bool tensor of `shape`."""
    n = math.prod(shape)
    return (uniform(key, n) < p).reshape(shape)


def gumbel(key, n: int, start: int = 0):
    """`jax.random.gumbel(key, (n,), float32)` (mode "low"), or entries
    [start, start + n) of a larger flattened shape:
    -log(-log(uniform(tiny, 1)))."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0, start)))


# Gumbel draws a chunk of `categorical(..., shape=...)` holds at once:
# the hash keeps about a dozen int64 temporaries of this size alive
DRAW_CHUNK = 1 << 24


def categorical(key, logits, shape=None):
    """`jax.random.categorical(key, logits)`: argmax of gumbel + logits
    over the last axis, ties to the first index as `jnp.argmax`.

    shape None: one key per row, key (..., 2), logits (..., V) f32 ->
    (...) int64.  Else one key (2,) and one (V,) logit row drawn `shape`
    times, as the reference's `categorical(key, logits, shape=shape)`:
    draw j takes entries [j V, (j + 1) V) of the (*shape, V) Gumbel
    array.  Draws are made in chunks of rows, so the temporaries stay
    near `DRAW_CHUNK` entries whatever the shape."""
    V = logits.shape[-1]
    if shape is None:
        return torch.argmax(gumbel(key, V) + logits, dim=-1)
    n = math.prod(shape)
    rows = max(1, DRAW_CHUNK // V)
    out = torch.empty((n,), dtype=torch.int64, device=logits.device)
    for r0 in range(0, n, rows):
        r = min(rows, n - r0)
        g = gumbel(key, r * V, start=r0 * V).reshape(r, V)
        out[r0:r0 + r] = torch.argmax(g + logits, dim=-1)
    return out.reshape(shape)
