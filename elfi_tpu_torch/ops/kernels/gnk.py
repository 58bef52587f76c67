"""Fused g-and-k simulate -> order statistics -> distance: the wrapper of
the CUDA kernel ``csrc/gnk_distance.cu`` and its plain PyTorch version.

Counterpart of :func:`elfi_tpu.ops.pallas_kernels.gnk_distance`.  The
wrapper launches the kernel for CUDA tensors and raises if it cannot; it
runs the plain version only for CPU tensors.  ``gnk_distance.launches``
counts the kernel launches, so a run can show it went through the kernel
(``captured`` and ``graph_launches`` count those recorded into CUDA graphs
and launched by their replays: :mod:`elfi_tpu_torch.utils.capture`).
The kernel has no backward, so ``gnk_distance`` gives no gradient on either
device: on the CPU its plain version runs without autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import capture
from ...utils.rng import stream_key
from . import _build, sort_network
from ._blocked import blocked_sum
from .ma2 import check_key

__all__ = ["gnk_distance", "gnk_distance_noise", "gnk_distance_reference",
           "gnk_sort_rows", "gnk_transform", "MAX_N_OBS", "NETWORK_ROWS"]

_LIB = "gnk_distance"
_SOURCES = ("gnk_distance.cu",)
_P = ctypes.c_void_p
#: rows of the kernel's general sorting network: n_obs may be 1 .. MAX_N_OBS
MAX_N_OBS = 64
#: the row counts of the kernel's instances: n_obs 50 has its own
#: network, any other n_obs takes the 64-row one
NETWORK_ROWS = sort_network.ROWS


@functools.cache
def _lib():
    """Build (at first use) and bind the kernel library."""
    lib = _build.load(_LIB, _SOURCES)
    lib.elfi_gnk_distance.argtypes = [
        _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int, _P]
    lib.elfi_gnk_distance.restype = ctypes.c_int
    lib.elfi_gnk_distance_seed_in.argtypes = [
        _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, _P, ctypes.c_int, _P]
    lib.elfi_gnk_distance_seed_in.restype = ctypes.c_int
    lib.elfi_gnk_distance_noise.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, _P]
    lib.elfi_gnk_distance_noise.restype = ctypes.c_int
    lib.elfi_gnk_sort_rows.argtypes = [_P, _P, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int, _P]
    lib.elfi_gnk_sort_rows.restype = ctypes.c_int
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _device_of(x):
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"expected a torch.Tensor, got {type(x)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def _check(params, obs, n_obs, batch_size, z=None):
    """Validate the kernel's contract; returns the common device."""
    if not isinstance(n_obs, int) or not 1 <= n_obs <= MAX_N_OBS:
        raise ValueError(f"n_obs must be an int in 1..{MAX_N_OBS}, got "
                         f"{n_obs!r}")
    if not isinstance(batch_size, int) or batch_size < 1:
        raise ValueError(f"batch_size must be an int >= 1, got "
                         f"{batch_size!r}")
    device = _device_of(params[0])
    for name, p in zip("ABgk", params):
        _build.check_tensor(name, p, (batch_size,), device)
    _build.check_tensor("observed_sorted", obs, (n_obs,), device)
    if z is not None:
        _build.check_tensor("z", z, (batch_size, n_obs), device)
    return device


def gnk_transform(z, A, B, g, k, c=0.8):
    """The g-and-k quantile function at ``z`` in the TPU kernel's form
    (``pallas_kernels.py:182-187``): ``A + B (1 + c tanh(g z / 2))
    exp(k log1p(z^2)) z`` with an overflow-stable tanh.  ``A`` .. ``k`` are
    (batch,) and ``z`` is (batch, n); each op rounds as the kernel does."""
    A, B, g, k = (p.reshape(-1, 1) for p in (A, B, g, k))
    x = 0.5 * g * z
    e = torch.exp(-2.0 * torch.abs(x))
    tanh = torch.sign(x) * (1.0 - e) / (1.0 + e)
    return A + B * (1.0 + c * tanh) * torch.exp(k * torch.log1p(z * z)) * z


def gnk_distance_reference(A, B, g, k, observed_sorted, n_obs=50, c=0.8,
                           batch_size=1, generator=None, z=None):
    """Plain PyTorch version: draw z (or take ``z``), transform, sort each
    row and take the euclidean distance to ``observed_sorted`` -- the JAX
    package's ``GNK`` + ``ss_order`` + ``euclidean_multiss``.

    The kernel's 64-row instance pads rows ``>= n_obs`` with +inf before
    it sorts; sorting the ``n_obs`` values alone gives the same first
    ``n_obs`` rows.  The differences and their squares are float32, summed
    in the kernel's order (:func:`._blocked.blocked_sum`: float32 blocks of
    8 rows, added in float64), and the distance is rounded to float32, as
    the kernel does.
    """
    if z is None:
        z = torch.randn((batch_size, n_obs), generator=generator,
                        device=A.device)
    ys = torch.sort(gnk_transform(z, A, B, g, k, c), dim=1).values
    d = ys - observed_sorted
    return torch.sqrt(blocked_sum(d * d)).float()


def gnk_distance(A, B, g, k, observed_sorted, n_obs=50, c=0.8, batch_size=1,
                 generator=None, key=None):
    """Fused g-and-k simulate+sort+distance; returns (batch,) float32.

    ``A``, ``B``, ``g``, ``k``: (batch_size,) float32; ``observed_sorted``:
    (n_obs,) float32 in ascending order (the caller sorts it once); all
    contiguous on one device, 1 <= n_obs <= 64.  On CUDA the kernel's
    Philox stream is keyed by ``key`` (as :func:`.ma2.ma2_distance`'s, by
    default :func:`~elfi_tpu_torch.utils.rng.stream_key` of
    ``generator``); on the CPU the plain version draws from ``generator``.
    """
    params = (A, B, g, k)
    device = _check(params, observed_sorted, n_obs, batch_size)
    if device.type == "cpu":
        # the kernel has no backward, so neither has its plain version here
        with torch.no_grad():
            return gnk_distance_reference(*params, observed_sorted, n_obs, c,
                                          batch_size, generator=generator)
    if key is None:
        if generator is None:
            raise ValueError("on CUDA gnk_distance needs a generator or a "
                             "key: it keys the kernel's Philox stream")
        key = stream_key(generator)
    key = check_key(key, device)
    lib = _lib()
    out = torch.empty(batch_size, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if isinstance(key, torch.Tensor):
        rc = lib.elfi_gnk_distance_seed_in(
            *(p.data_ptr() for p in params), observed_sorted.data_ptr(),
            out.data_ptr(), batch_size, n_obs, float(c), key.data_ptr(),
            device.index, stream)
        _build.raise_on(rc, lib, "elfi_gnk_distance_seed_in")
    else:
        rc = lib.elfi_gnk_distance(
            *(p.data_ptr() for p in params), observed_sorted.data_ptr(),
            out.data_ptr(), batch_size, n_obs, float(c), key, device.index,
            stream)
        _build.raise_on(rc, lib, "elfi_gnk_distance")
    capture.count(gnk_distance)
    return out


capture.counted(gnk_distance)


def gnk_distance_noise(A, B, g, k, observed_sorted, z, c=0.8):
    """The kernel's noise-injection entry: the same transform, sort and
    distance on given normals ``z`` (batch, n_obs) instead of its own
    draws.  It exists to hold the kernel's arithmetic against the plain
    version exactly."""
    if not isinstance(z, torch.Tensor) or z.ndim != 2:
        raise ValueError("z must be a (batch, n_obs) torch.Tensor")
    batch_size, n_obs = (int(s) for s in z.shape)
    params = (A, B, g, k)
    device = _check(params, observed_sorted, n_obs, batch_size, z)
    if device.type == "cpu":
        return gnk_distance_reference(*params, observed_sorted, n_obs, c,
                                      batch_size, z=z)
    lib = _lib()
    out = torch.empty(batch_size, dtype=torch.float32, device=device)
    rc = lib.elfi_gnk_distance_noise(
        *(p.data_ptr() for p in params), observed_sorted.data_ptr(),
        z.data_ptr(), out.data_ptr(), batch_size, n_obs, float(c),
        device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_gnk_distance_noise")
    gnk_distance_noise.launches += 1
    return out


gnk_distance_noise.launches = 0


def gnk_sort_rows(y):
    """The kernel's sorting network alone: each row of ``y`` (batch, rows)
    float32 sorted ascending by the instance of ``rows`` rows, one of
    ``NETWORK_ROWS``.  On the CPU it is ``torch.sort``, which the network
    must equal exactly on the card, +inf pads and ties included."""
    device = _device_of(y)
    if y.ndim != 2 or int(y.shape[1]) not in NETWORK_ROWS:
        raise ValueError(f"y must be (batch, rows) with rows in "
                         f"{NETWORK_ROWS}, got {tuple(y.shape)}")
    batch, rows = (int(s) for s in y.shape)
    _build.check_tensor("y", y, (batch, rows), device)
    if batch < 1:
        raise ValueError("y must have at least one row")
    if device.type == "cpu":
        return torch.sort(y, dim=1).values
    lib = _lib()
    out = torch.empty_like(y)
    rc = lib.elfi_gnk_sort_rows(y.data_ptr(), out.data_ptr(), batch, rows,
                                device.index,
                                torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_gnk_sort_rows")
    gnk_sort_rows.launches += 1
    return out


gnk_sort_rows.launches = 0
