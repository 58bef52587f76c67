"""Fused MA2 simulate -> summarise -> distance: the wrapper of the CUDA
kernel ``csrc/ma2_distance.cu`` and its plain PyTorch version.

Counterpart of :func:`elfi_tpu.ops.pallas_kernels.ma2_distance`.  The
wrapper launches the kernel for CUDA tensors and raises if it cannot; it
runs the plain version only for CPU tensors.  ``ma2_distance.launches``
counts the kernel launches, so a run can show it went through the kernel
(``captured`` and ``graph_launches`` count those recorded into CUDA graphs
and launched by their replays: :mod:`elfi_tpu_torch.utils.capture`).
The kernel has no backward, so ``ma2_distance`` gives no gradient on either
device: on the CPU its plain version runs without autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import capture
from ...utils.rng import stream_key
from . import _build
from ._blocked import blocked_sum

__all__ = ["ma2_distance", "ma2_distance_noise", "ma2_distance_reference",
           "philox_normals", "check_key"]

_LIB = "ma2_distance"
_SOURCES = ("ma2_distance.cu",)
_P = ctypes.c_void_p


@functools.cache
def _lib():
    """Build (at first use) and bind the kernel library."""
    lib = _build.load(_LIB, _SOURCES)
    lib.elfi_ma2_distance.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_int, _P]
    lib.elfi_ma2_distance.restype = ctypes.c_int
    lib.elfi_ma2_distance_seed_in.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int,
        _P]
    lib.elfi_ma2_distance_seed_in.restype = ctypes.c_int
    lib.elfi_ma2_distance_noise.argtypes = [
        _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, _P]
    lib.elfi_ma2_distance_noise.restype = ctypes.c_int
    lib.elfi_philox_normals.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_ulonglong, ctypes.c_int, _P]
    lib.elfi_philox_normals.restype = ctypes.c_int
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t1, t2, obs, n_obs, batch_size, noise=None):
    """Validate the kernel's contract; returns the common device."""
    if not isinstance(n_obs, int) or n_obs < 3:
        raise ValueError(f"n_obs must be an int >= 3, got {n_obs!r}")
    if not isinstance(batch_size, int) or batch_size < 1:
        raise ValueError(f"batch_size must be an int >= 1, got "
                         f"{batch_size!r}")
    if not isinstance(t1, torch.Tensor):
        raise ValueError(f"t1 must be a torch.Tensor, got {type(t1)}")
    device = t1.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    _build.check_tensor("t1", t1, (batch_size,), device)
    _build.check_tensor("t2", t2, (batch_size,), device)
    _build.check_tensor("observed_autocovs", obs, (2,), device)
    if noise is not None:
        _build.check_tensor("noise", noise, (batch_size, n_obs + 2), device)
    return device


def ma2_distance_reference(t1, t2, obs, n_obs, batch_size, generator=None,
                           noise=None):
    """Plain PyTorch version: draw w (or take ``noise``), filter, take the
    lag-1/lag-2 autocovariances and the euclidean distance to ``obs`` --
    the JAX package's ``MA2`` + ``autocov`` + euclidean.

    The series and the lag products are float32, rounded as the kernel
    rounds them; the products are summed in the kernel's order
    (:func:`._blocked.blocked_sum`: float32 blocks of 8, added in float64)
    and the distance is taken in float64, as the kernel does.  A float32
    mean summed in another order differs by up to ~3e-4 relative where the
    distance is small, since ``d`` is then a difference of nearly equal
    sums.
    """
    if noise is None:
        noise = torch.randn((batch_size, n_obs + 2), generator=generator,
                            device=t1.device)
    t1 = t1.reshape(-1, 1)
    t2 = t2.reshape(-1, 1)
    x = noise[:, 2:] + t1 * noise[:, 1:-1] + t2 * noise[:, :-2]
    s1 = blocked_sum(x[:, 1:] * x[:, :-1]) / (n_obs - 1)
    s2 = blocked_sum(x[:, 2:] * x[:, :-2]) / (n_obs - 2)
    obs = obs.double()
    d1 = s1 - obs[0]
    d2 = s2 - obs[1]
    return torch.sqrt(d1 * d1 + d2 * d2).float()


def check_key(key, device):
    """A kernel's stream key: an int (a launch argument) or a 1-element
    int64 tensor on ``device`` that the kernel reads when it runs."""
    if isinstance(key, torch.Tensor):
        if (key.dtype != torch.int64 or key.numel() != 1
                or key.device != device):
            raise ValueError(f"a key tensor must be one int64 on {device}, "
                             f"got {key.dtype} {tuple(key.shape)} on "
                             f"{key.device}")
        return key
    if isinstance(key, int) and 0 <= key < 2**64:
        return key
    raise ValueError(f"a key must be a 64-bit unsigned int or an int64 "
                     f"tensor, got {key!r}")


def ma2_distance(t1, t2, observed_autocovs, n_obs=100, batch_size=1,
                 generator=None, key=None):
    """Fused MA2 simulate+summarise+distance; returns (batch,) float32.

    ``t1``, ``t2``: (batch_size,) float32; ``observed_autocovs``: (2,)
    float32 observed (lag-1, lag-2) autocovariances; all contiguous on one
    device.  On CUDA the kernel's Philox stream is keyed by ``key``, by
    default :func:`~elfi_tpu_torch.utils.rng.stream_key` of ``generator``:
    an int, or a 1-element int64 tensor on the device that the kernel reads
    when it runs (in a CUDA graph, refilled before each replay); the two
    give the same result for the same seed.  On the CPU the plain version
    draws from ``generator``.
    """
    device = _check(t1, t2, observed_autocovs, n_obs, batch_size)
    if device.type == "cpu":
        # the kernel has no backward, so neither has its plain version here
        with torch.no_grad():
            return ma2_distance_reference(t1, t2, observed_autocovs, n_obs,
                                          batch_size, generator=generator)
    if key is None:
        if generator is None:
            raise ValueError("on CUDA ma2_distance needs a generator or a "
                             "key: it keys the kernel's Philox stream")
        key = stream_key(generator)
    key = check_key(key, device)
    lib = _lib()
    out = torch.empty(batch_size, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if isinstance(key, torch.Tensor):
        rc = lib.elfi_ma2_distance_seed_in(
            t1.data_ptr(), t2.data_ptr(), observed_autocovs.data_ptr(),
            out.data_ptr(), batch_size, n_obs, key.data_ptr(), device.index,
            stream)
        _build.raise_on(rc, lib, "elfi_ma2_distance_seed_in")
    else:
        rc = lib.elfi_ma2_distance(
            t1.data_ptr(), t2.data_ptr(), observed_autocovs.data_ptr(),
            out.data_ptr(), batch_size, n_obs, key, device.index, stream)
        _build.raise_on(rc, lib, "elfi_ma2_distance")
    capture.count(ma2_distance)
    return out


capture.counted(ma2_distance)


def ma2_distance_noise(t1, t2, observed_autocovs, noise):
    """The kernel's noise-injection entry: the same filter, summaries and
    distance on a given ``noise`` (batch, n_obs + 2) instead of its own
    draws.  It exists to hold the kernel's arithmetic against the plain
    version exactly."""
    batch_size, n_obs = int(t1.shape[0]), int(noise.shape[1]) - 2
    device = _check(t1, t2, observed_autocovs, n_obs, batch_size, noise)
    if device.type == "cpu":
        return ma2_distance_reference(t1, t2, observed_autocovs, n_obs,
                                      batch_size, noise=noise)
    lib = _lib()
    out = torch.empty(batch_size, dtype=torch.float32, device=device)
    rc = lib.elfi_ma2_distance_noise(
        t1.data_ptr(), t2.data_ptr(), observed_autocovs.data_ptr(),
        noise.data_ptr(), out.data_ptr(), batch_size, n_obs, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_ma2_distance_noise")
    ma2_distance_noise.launches += 1
    return out


ma2_distance_noise.launches = 0


def philox_normals(batch_size, n, generator):
    """The normals the port's kernels draw (``csrc/philox.cuh``: Philox
    and ``box_muller_fast``), to check their distribution: (batch_size, n)
    float32 on ``generator``'s device, row i the first n normals of
    simulation i's stream under ``generator.initial_seed()``.  On the CPU
    it is ``torch.randn``, the distribution they must follow."""
    for name, v, low in (("batch_size", batch_size, 1), ("n", n, 1)):
        if not isinstance(v, int) or v < low:
            raise ValueError(f"{name} must be an int >= {low}, got {v!r}")
    device = generator.device
    if device.type == "cpu":
        return torch.randn((batch_size, n), generator=generator)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _lib()
    out = torch.empty((batch_size, n), dtype=torch.float32, device=device)
    rc = lib.elfi_philox_normals(
        out.data_ptr(), batch_size, n, generator.initial_seed(),
        device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_philox_normals")
    philox_normals.launches += 1
    return out


philox_normals.launches = 0
