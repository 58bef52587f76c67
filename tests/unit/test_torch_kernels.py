"""The MA2 distance kernel of the PyTorch port (``ops/kernels/ma2.py`` and
``csrc/ma2_distance.cu``).

On the CPU the wrapper runs the kernel's plain PyTorch version, which is
held here against the JAX package's ``MA2`` + ``autocov`` + euclidean on the
same noise.  The tests marked ``cuda`` launch the kernel itself and skip
without a card.  This file imports JAX only inside the tests that compare
with it, so on a machine with a card and no JAX

    python -m pytest --noconftest -m cuda tests/unit/test_torch_kernels.py

runs the kernel's tests alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.ops.kernels import _build
from elfi_tpu_torch.ops.kernels._blocked import BLOCK, blocked_sum
from elfi_tpu_torch.ops.kernels.ma2 import (ma2_distance, ma2_distance_noise,
                                            ma2_distance_reference,
                                            philox_normals)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


N_OBS = 100
# float32 sums are taken in another order by the two frameworks
RTOL, ATOL = 1e-5, 1e-6


def _params(b, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    t1 = torch.tensor(rng.uniform(-2, 2, b).astype(np.float32), device=device)
    t2 = torch.tensor(rng.uniform(-1, 1, b).astype(np.float32), device=device)
    obs = torch.tensor([0.9, 0.35], dtype=torch.float32, device=device)
    return t1, t2, obs


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize("n_obs", [3, N_OBS])
def test_plain_version_equals_jax_on_the_same_noise(n_obs):
    import jax
    import jax.numpy as jnp

    from elfi_tpu.models.ma2 import MA2, autocov

    b = 2048
    t1, t2, obs = _params(b, seed=n_obs)
    key = jax.random.key(n_obs)
    # MA2 draws exactly this array (elfi_tpu/models/ma2.py:29)
    w = np.asarray(jax.random.normal(key, (b, n_obs + 2)))
    x = MA2(jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy()), n_obs=n_obs,
            batch_size=b, key=key)
    o = obs.numpy()
    d_jax = np.asarray(jnp.sqrt((autocov(x) - o[0]) ** 2
                                + (autocov(x, 2) - o[1]) ** 2))
    d_ref = ma2_distance_reference(t1, t2, obs, n_obs, b,
                                   noise=torch.tensor(w))
    d_noise = ma2_distance_noise(t1, t2, obs, torch.tensor(w))
    np.testing.assert_allclose(d_ref.numpy(), d_jax, rtol=RTOL, atol=ATOL)
    assert torch.equal(d_noise, d_ref)


@pytest.mark.parametrize("n", [1, 7, 8, 17, 98, 99])
def test_blocked_sum_is_the_kernels_order(n):
    """float32 blocks of BLOCK terms, each summed left to right from 0, the
    block sums added in order in float64: the same bits as the loops the
    kernels run, and within float32 rounding of the exact sum."""
    rng = np.random.default_rng(n)
    terms = torch.tensor(rng.normal(size=(64, n)).astype(np.float32) ** 3)
    want = []
    for row in terms.numpy():
        s = np.float64(0.0)
        for b0 in range(0, n, BLOCK):
            acc = np.float32(0.0)
            for t in row[b0:b0 + BLOCK]:
                acc = np.float32(acc + t)
            s = s + np.float64(acc)
        want.append(s)
    got = blocked_sum(terms)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    exact = terms.double().sum(dim=1)
    scale = terms.double().abs().sum(dim=1)
    assert bool(((got - exact).abs() <= 8 * 2.0**-24 * scale).all())


def test_cpu_normals_are_randn():
    z = philox_normals(16, 5, _gen(7))
    assert torch.equal(z, torch.randn((16, 5), generator=_gen(7)))
    with pytest.raises(ValueError):
        philox_normals(0, 5, _gen(7))
    with pytest.raises(ValueError):
        philox_normals(16, 0, _gen(7))


def test_cpu_wrapper_runs_the_plain_version():
    b = 512
    t1, t2, obs = _params(b)
    before = ma2_distance.launches
    d = ma2_distance(t1, t2, obs, n_obs=N_OBS, batch_size=b,
                     generator=_gen(3))
    ref = ma2_distance_reference(t1, t2, obs, N_OBS, b, generator=_gen(3))
    assert torch.equal(d, ref)
    assert d.shape == (b,) and d.dtype == torch.float32
    assert ma2_distance.launches == before       # no kernel on the CPU


def _bad_calls():
    t1, t2, obs = _params(8)
    ok = dict(t1=t1, t2=t2, observed_autocovs=obs, n_obs=N_OBS,
              batch_size=8)
    yield "dtype", {**ok, "t1": t1.double()}
    yield "shape", {**ok, "t2": t2[:4]}
    yield "batch", {**ok, "batch_size": 16}
    yield "obs", {**ok, "observed_autocovs": torch.zeros(3)}
    yield "contiguous", {**ok, "t1": torch.stack([t1, t1], 1)[:, 0]}
    yield "n_obs", {**ok, "n_obs": 2}
    yield "batch_size", {**ok, "t1": t1[:0], "t2": t2[:0], "batch_size": 0}
    yield "tensor", {**ok, "t1": t1.numpy()}
    yield "device", {**ok, "t1": t1.to("meta")}


@pytest.mark.parametrize("case", [c for c, _ in _bad_calls()])
def test_wrapper_validation(case):
    kwargs = dict(_bad_calls())[case]
    with pytest.raises(ValueError):
        ma2_distance(**kwargs, generator=_gen(0))


def test_noise_entry_validation():
    t1, t2, obs = _params(8)
    with pytest.raises(ValueError):
        ma2_distance_noise(t1, t2, obs, torch.zeros(8, N_OBS + 2,
                                                    dtype=torch.float64))
    with pytest.raises(ValueError):
        ma2_distance_noise(t1, t2, obs, torch.zeros(4, N_OBS + 2))
    with pytest.raises(ValueError):                      # n_obs = 2
        ma2_distance_noise(t1, t2, obs, torch.zeros(8, 4))


def test_cuda_source_is_in_the_package():
    sources = {
        "ma2_distance.cu": ("elfi_ma2_distance(", "elfi_ma2_distance_noise(",
                            "elfi_cuda_error_string(",
                            "elfi_tpu/ops/pallas_kernels.py:_ma2_kernel"),
        "gnk_distance.cu": ("elfi_gnk_distance(", "elfi_gnk_distance_noise(",
                            "elfi_gnk_sort_rows(", "elfi_cuda_error_string(",
                            "elfi_tpu/ops/pallas_kernels.py:_gnk_kernel"),
    }
    for name, entries in sources.items():
        text = (_build.CSRC / name).read_text()
        for entry in entries:
            assert entry in text, (name, entry)
        assert '#include "philox.cuh"' in text
        assert "torch/extension.h" not in text
    header = (_build.CSRC / "philox.cuh").read_text()
    for helper in ("philox4x32_10(", "philox_block(", "open_uniform(",
                   "box_muller_fast("):
        assert helper in header
    assert '#include "sort_network.cuh"' in \
        (_build.CSRC / "gnk_distance.cu").read_text()
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    p1 = _build.library_path("k", ("k.cu",))
    assert p1 == _build.library_path("k", ("k.cu",))
    (tmp_path / "k.cu").write_text("// two")
    p2 = _build.library_path("k", ("k.cu",))
    assert p1 != p2 and p1.parent == p2.parent == _build.BUILD_DIR
    # a header may be included by any source: editing one rebuilds
    (tmp_path / "h.cuh").write_text("// h1")
    p3 = _build.library_path("k", ("k.cu",))
    (tmp_path / "h.cuh").write_text("// h2")
    p4 = _build.library_path("k", ("k.cu",))
    assert len({p2, p3, p4}) == 3


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    import shutil

    import torch.utils.cpp_extension as cpp_extension
    (tmp_path / "k.cu").write_text("// k")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("k_no_nvcc", ("k.cu",))
    assert not (tmp_path / "build").exists()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_obs", [(1000, N_OBS), (4096, 3), (257, 17)])
def test_kernel_equals_plain_version_on_the_same_noise(cuda, b, n_obs):
    t1, t2, obs = _params(b, seed=b, device=cuda)
    noise = torch.randn((b, n_obs + 2), generator=_gen(1, cuda),
                        device=cuda)
    d_k = ma2_distance_noise(t1, t2, obs, noise)
    d_p = ma2_distance_reference(t1, t2, obs, n_obs, b, noise=noise)
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_statistics_match_plain_version(cuda):
    from elfi_tpu_torch.models.ma2 import autocov, observed_data
    y = torch.as_tensor(observed_data(seed_obs=271))[None]
    obs = torch.tensor([float(autocov(y)[0]), float(autocov(y, 2)[0])],
                       device=cuda)
    b = 1 << 16
    t1 = torch.full((b,), 0.6, device=cuda)
    t2 = torch.full((b,), 0.2, device=cuda)
    d_k = ma2_distance(t1, t2, obs, N_OBS, b, generator=_gen(0, cuda))
    d_p = ma2_distance_reference(t1, t2, obs, N_OBS, b,
                                 generator=_gen(1, cuda))
    assert bool(torch.isfinite(d_k).all())
    assert abs(float(d_k.mean()) - float(d_p.mean())) < 0.02
    assert abs(float(d_k.std()) - float(d_p.std())) < 0.02


def _sorted_and_ks(x):
    """The values of ``x`` sorted, and their Kolmogorov-Smirnov distance to
    the standard normal CDF."""
    v = torch.sort(x.flatten()).values
    n = v.numel()
    cdf = torch.special.ndtr(v.double())
    i = torch.arange(n, dtype=torch.float64, device=v.device)
    return v, float(torch.maximum((i + 1) / n - cdf, cdf - i / n).max())


@pytest.mark.cuda
def test_box_muller_fast_matches_randn(cuda):
    """The kernels' normals (Philox and box_muller_fast) against torch.randn
    at 2^20 x 102 values, within a few sampling sigmas: mean and std within
    1e-3 (sigmas 1e-4 and 7e-5), the 1e-4 and 1 - 1e-4 quantiles within
    0.02 (sigma 2.4e-3) and the KS distance to the normal CDF under 3e-4
    (typically 8e-5; a radius 1 % off gives 2.4e-3)."""
    before = philox_normals.launches
    z = philox_normals(1 << 20, 102, _gen(5, cuda))
    r = torch.randn((1 << 20, 102), generator=_gen(6, cuda), device=cuda)
    assert philox_normals.launches == before + 1
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean()) - float(r.mean())) < 1e-3
    assert abs(float(z.std()) - float(r.std())) < 1e-3
    (vz, ks), (vr, _) = _sorted_and_ks(z), _sorted_and_ks(r)
    n = vz.numel()
    for q in (1e-4, 1 - 1e-4):
        i = round(q * (n - 1))
        assert abs(float(vz[i]) - float(vr[i])) < 0.02, q
    assert ks < 3e-4


@pytest.mark.cuda
def test_kernel_deterministic_counted_and_grid_independent(cuda):
    b = 4096
    t1, t2, obs = _params(2 * b, device=cuda)
    before = ma2_distance.launches
    a = ma2_distance(t1[:b], t2[:b], obs, N_OBS, b, generator=_gen(3, cuda))
    a2 = ma2_distance(t1[:b], t2[:b], obs, N_OBS, b,
                      generator=_gen(3, cuda))
    c = ma2_distance(t1[:b], t2[:b], obs, N_OBS, b, generator=_gen(4, cuda))
    # simulation i draws from counter (i, draw): a longer batch with the
    # same seed starts with the same simulations
    long = ma2_distance(t1, t2, obs, N_OBS, 2 * b, generator=_gen(3, cuda))
    assert ma2_distance.launches == before + 4
    assert torch.equal(a, a2)
    assert not torch.equal(a, c)
    assert torch.equal(a, long[:b])


@pytest.mark.cuda
def test_kernel_needs_a_generator_on_cuda(cuda):
    t1, t2, obs = _params(8, device=cuda)
    with pytest.raises(ValueError, match="generator"):
        ma2_distance(t1, t2, obs, N_OBS, 8)
    with pytest.raises(ValueError):
        ma2_distance(t1, t2.cpu(), obs, N_OBS, 8, generator=_gen(0, cuda))
