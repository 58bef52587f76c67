"""The g-and-k distance kernel of the PyTorch port (``ops/kernels/gnk.py``
and ``csrc/gnk_distance.cu``).

On the CPU the wrapper runs the kernel's plain PyTorch version; the plain
version is held against the JAX package in ``test_torch_gnk.py``.  The
tests marked ``cuda`` launch the kernel itself and skip without a card.
This file does not import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_gnk_kernel.py

runs the kernel's tests alone.
"""

import math

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.ops.kernels import sort_network
from elfi_tpu_torch.ops.kernels.gnk import (MAX_N_OBS, NETWORK_ROWS,
                                            gnk_distance, gnk_distance_noise,
                                            gnk_distance_reference,
                                            gnk_sort_rows)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


N_OBS = 50


def _params(b, seed=0, device="cpu"):
    """(A, B, g, k) from the g-and-k priors, uniform(0, 10)."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.uniform(0, 10, b).astype(np.float32),
                         device=device) for _ in range(4)]


def _obs(n_obs=N_OBS, device="cpu"):
    rng = np.random.default_rng(1)
    return torch.tensor(np.sort(rng.normal(3, 1, n_obs)).astype(np.float32),
                        device=device)


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def test_cpu_wrapper_runs_the_plain_version():
    b = 512
    P, obs = _params(b), _obs()
    before = gnk_distance.launches
    d = gnk_distance(*P, obs, n_obs=N_OBS, batch_size=b, generator=_gen(3))
    ref = gnk_distance_reference(*P, obs, N_OBS, batch_size=b,
                                 generator=_gen(3))
    assert torch.equal(d, ref)
    assert d.shape == (b,) and d.dtype == torch.float32
    assert bool(torch.isfinite(d).all())
    z = torch.randn((b, N_OBS), generator=_gen(4))
    assert torch.equal(gnk_distance_noise(*P, obs, z),
                       gnk_distance_reference(*P, obs, N_OBS, batch_size=b,
                                              z=z))
    y = torch.randn((b, MAX_N_OBS), generator=_gen(5))
    y[:, N_OBS:] = math.inf
    assert torch.equal(gnk_sort_rows(y), torch.sort(y, dim=1).values)
    assert gnk_distance.launches == before       # no kernel on the CPU


def _rows_to_sort(b, n_obs, rows, seed):
    """(b, rows) float32 rows: n_obs values, +inf pads beyond them, and
    ties in every other row."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, rows)).astype(np.float32)
    y[1::2, : n_obs // 2] = y[1::2, :1]
    y[:, n_obs:] = np.inf
    return y


@pytest.mark.parametrize("n_obs", [17, 50, 64])
def test_sort_network_equals_np_sort(n_obs):
    """The comparators the kernel runs for n_obs (its 50-row instance at
    50, the 64-row one with +inf pads otherwise) sort as np.sort does."""
    rows = 50 if n_obs == 50 else MAX_N_OBS
    y = _rows_to_sort(512, n_obs, rows, seed=n_obs)
    got = sort_network.apply(sort_network.network(rows), y.copy())
    np.testing.assert_array_equal(got, np.sort(y, axis=1))


def test_sort_network_sizes_and_committed_header():
    assert NETWORK_ROWS == (50, MAX_N_OBS)
    assert len(sort_network.batcher_pairs(64)) == 543
    assert len(sort_network.network(50)) == 403
    assert sort_network.network(64) == sort_network.batcher_pairs(64)
    for rows in NETWORK_ROWS:
        assert all(a < b < rows for a, b in sort_network.network(rows))
    # the header the kernel includes is the generator's output
    assert sort_network.HEADER.read_text() == sort_network.header()


def test_cpu_sort_rows_takes_both_instances():
    for rows in NETWORK_ROWS:
        y = torch.tensor(_rows_to_sort(64, 40, rows, seed=rows))
        assert torch.equal(gnk_sort_rows(y), torch.sort(y, dim=1).values)


def _bad_calls():
    P, obs = _params(8), _obs()
    ok = dict(A=P[0], B=P[1], g=P[2], k=P[3], observed_sorted=obs,
              n_obs=N_OBS, batch_size=8)
    yield "dtype", {**ok, "A": P[0].double()}
    yield "shape", {**ok, "B": P[1][:4]}
    yield "batch", {**ok, "batch_size": 16}
    yield "obs", {**ok, "observed_sorted": obs[:10]}
    yield "contiguous", {**ok, "g": torch.stack([P[2], P[2]], 1)[:, 0]}
    yield "n_obs_0", {**ok, "n_obs": 0, "observed_sorted": obs[:0]}
    yield "n_obs_65", {**ok, "n_obs": 65,
                       "observed_sorted": torch.zeros(65)}
    yield "batch_size", {**ok, "batch_size": 0,
                         **{n: p[:0] for n, p in zip("ABgk", P)}}
    yield "tensor", {**ok, "k": P[3].numpy()}
    yield "first_tensor", {**ok, "A": P[0].numpy()}
    yield "device", {**ok, "A": P[0].to("meta")}


@pytest.mark.parametrize("case", [c for c, _ in _bad_calls()])
def test_wrapper_validation(case):
    kwargs = dict(_bad_calls())[case]
    with pytest.raises(ValueError):
        gnk_distance(**kwargs, generator=_gen(0))


def test_debug_entries_validation():
    P, obs = _params(8), _obs()
    with pytest.raises(ValueError):
        gnk_distance_noise(*P, obs, torch.zeros(8, N_OBS,
                                                dtype=torch.float64))
    with pytest.raises(ValueError):
        gnk_distance_noise(*P, obs, torch.zeros(4, N_OBS))
    with pytest.raises(ValueError):
        gnk_distance_noise(*P, obs, torch.zeros(8 * N_OBS))
    with pytest.raises(ValueError):                       # n_obs = 65
        gnk_distance_noise(*P, torch.zeros(65), torch.zeros(8, 65))
    with pytest.raises(ValueError):
        gnk_sort_rows(torch.zeros(8, 32))
    with pytest.raises(ValueError):
        gnk_sort_rows(torch.zeros(0, MAX_N_OBS))
    with pytest.raises(ValueError):
        gnk_sort_rows(torch.zeros(8, MAX_N_OBS, dtype=torch.float64))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_obs", [(1000, N_OBS), (4096, 1), (257, 17),
                                     (300, MAX_N_OBS)])
def test_kernel_equals_plain_version_on_the_same_noise(cuda, b, n_obs):
    P, obs = _params(b, seed=b, device=cuda), _obs(n_obs, cuda)
    z = torch.randn((b, n_obs), generator=_gen(1, cuda), device=cuda)
    d_k = gnk_distance_noise(*P, obs, z)
    d_p = gnk_distance_reference(*P, obs, n_obs, batch_size=b, z=z)
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", NETWORK_ROWS)
def test_kernel_sort_equals_torch_sort(cuda, rows):
    b = 4099
    y = torch.randn((b, rows), generator=_gen(2, cuda), device=cuda)
    y[::3, 17:] = math.inf                     # the n_obs = 17 padding
    y[1::3, 40:] = y[1::3, :1]                 # ties
    before = gnk_sort_rows.launches
    got = gnk_sort_rows(y)
    assert gnk_sort_rows.launches == before + 1
    assert torch.equal(got, torch.sort(y, dim=1).values)


@pytest.mark.cuda
def test_kernel_statistics_match_plain_version(cuda):
    """The kernel's own Philox stream against torch.randn: the distance
    distributions at the true parameters agree (the JAX package's
    test_pallas.py check, mean and median within 15 %)."""
    b = 1 << 16
    P = [torch.full((b,), v, device=cuda) for v in (3.0, 1.0, 2.0, 0.5)]
    obs = _obs(N_OBS, cuda)
    d_k = gnk_distance(*P, obs, N_OBS, batch_size=b,
                       generator=_gen(0, cuda))
    d_p = gnk_distance_reference(*P, obs, N_OBS, batch_size=b,
                                 generator=_gen(1, cuda))
    assert bool(torch.isfinite(d_k).all())
    assert abs(float(d_k.mean() - d_p.mean())) < 0.15 * float(d_p.mean())
    assert abs(float(d_k.median() - d_p.median())) < \
        0.15 * float(d_p.median())


@pytest.mark.cuda
def test_kernel_deterministic_counted_and_grid_independent(cuda):
    b = 4096
    P, obs = _params(2 * b, device=cuda), _obs(N_OBS, cuda)
    head = [p[:b] for p in P]
    before = gnk_distance.launches
    a = gnk_distance(*head, obs, N_OBS, batch_size=b,
                     generator=_gen(3, cuda))
    a2 = gnk_distance(*head, obs, N_OBS, batch_size=b,
                      generator=_gen(3, cuda))
    c = gnk_distance(*head, obs, N_OBS, batch_size=b,
                     generator=_gen(4, cuda))
    # simulation i draws from counter (i, block): a longer batch with the
    # same seed starts with the same simulations
    long = gnk_distance(*P, obs, N_OBS, batch_size=2 * b,
                        generator=_gen(3, cuda))
    assert gnk_distance.launches == before + 4
    assert torch.equal(a, a2)
    assert not torch.equal(a, c)
    assert torch.equal(a, long[:b])


@pytest.mark.cuda
def test_kernel_needs_a_generator_on_cuda(cuda):
    P, obs = _params(8, device=cuda), _obs(N_OBS, cuda)
    with pytest.raises(ValueError, match="generator"):
        gnk_distance(*P, obs, N_OBS, batch_size=8)
    with pytest.raises(ValueError):
        gnk_distance(*P[:3], P[3].cpu(), obs, N_OBS, batch_size=8,
                     generator=_gen(0, cuda))
