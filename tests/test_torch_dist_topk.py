"""The binned distance top-k: its plain PyTorch version against the Pallas
reference (interpret mode, as ``dense_nn.knn`` runs it off TPU), the recall
contract of ``tests/unit/test_dist_topk.py``, and the CUDA kernel against
the plain version on the card.

JAX is imported inside the one test that needs it, so that the card-only
tests run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_dist_topk.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.kernels.dist_topk import (dist_topk, dist_topk_reference,
                                              launch_geometry)

torch.set_num_threads(1)


def _launches() -> int:
    """The dist_topk kernel's launches so far in this process."""
    return profiling.counters().get("kernel.dist_topk", (0, 0.0))[0]


# (queries, targets, bin_factor) of the four calls per frame at the
# tiny_test_config() shapes (32 x 1024 rings, maps 8192 / 16384) ...
TINY_PATH = [(512, 1536, 4), (1024, 3072, 4), (512, 8192, 4),
             (1024, 16384, 32)]
# ... and at the full 64 x 2048 bench shapes (maps 16384 / 32768).
FULL_PATH = [(1024, 3072, 4), (2048, 6144, 4), (1024, 16384, 32),
             (2048, 32768, 32)]
# The smoother's two calls per frame and pass at 64 x 2048 with the command
# line's default half-window of 8: queries against the window map of
# (2 * 8 + 1) frames' targets, 17 x 3072 edges and 17 x 6144 planars (17 and
# 34 tiles of 96 bins, where the forward path has 1-8 tiles of 128-768).
SMOOTH_PATH = [(1024, 17 * 3072, 32), (2048, 17 * 6144, 32)]


def _problem(seed, q, n, spread=30.0, noise=0.5, masked=0.1):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    tm = rng.random(n) >= masked
    qs = (t[rng.integers(0, n, q)]
          + rng.normal(0, noise, (q, 3))).astype(np.float32)
    return t, tm, qs


def _edge_problem(name):
    """Inputs off the beaten path -> (targets, mask, queries, bin_factor).

    ``few_live``: all but 10 of 3072 targets masked, so fewer than k = 16
    bins are live and the trailing rounds repeat one bin; ``duplicates``:
    every target of the second quarter repeats one of the first (an exact
    tie inside a bin: elements j and j + 768 share bin j) and every odd
    target of the first quarter repeats its left neighbour (an exact tie
    across two bins); ``q1000``: a query count that is no multiple of the
    reference's 256-row padding or of the kernel's query tile."""
    n, bf = 3072, 4
    if name == "few_live":
        t, tm, qs = _problem(21, 256, n)
        tm = np.zeros(n, bool)
        tm[np.random.default_rng(22).choice(n, 10, replace=False)] = True
    elif name == "duplicates":
        t, tm, qs = _problem(23, 512, n, masked=0.0)
        t[1:768:2] = t[0:767:2]
        t[768:1536] = t[0:768]
        qs = (t[np.random.default_rng(24).integers(0, 1536, 512)]
              + np.float32(0.25)).astype(np.float32)
    elif name == "q1000":
        t, tm, qs = _problem(25, 1000, n)
    else:
        raise ValueError(name)
    return t, tm, qs, bf


EDGE_CASES = ["few_live", "duplicates", "q1000"]


def _exact(t, tm, qs, k):
    D = ((qs[:, None, :].astype(np.float64) - t[None, :, :]) ** 2).sum(-1)
    D[:, ~tm] = np.inf
    return D, np.argsort(D, axis=1, kind="stable")[:, :k]


# The last two: many tiles of few bins, as a smoother window gives (17 tiles
# of 32 bins, 51 tiles of 8 bins).
@pytest.mark.parametrize("q,n,bf", TINY_PATH + [(256, 17 * 1024, 32),
                                                (256, 17 * 768, 32)])
def test_plain_matches_pallas_reference(q, n, bf):
    import jax.numpy as jnp

    from velo_tpu.pallas.dist_topk import dist_topk as jax_dist_topk

    t, tm, qs = _problem(n, q, n)
    jd2, jidx = (np.asarray(x) for x in jax_dist_topk(
        jnp.asarray(t), jnp.asarray(tm), jnp.asarray(qs), k=16,
        bin_factor=bf, interpret=True))
    td2, tidx = (x.numpy() for x in dist_topk(
        torch.tensor(t), torch.tensor(tm), torch.tensor(qs), k=16,
        bin_factor=bf))
    valid = jd2 <= 1e20
    assert valid.mean() > 0.99
    # d2 = s + |q|^2 cancels two terms of size |q|^2 + |t|^2 (up to ~2700
    # m^2 here), whose float32 sums the backends order differently: compare
    # at 1e-5 relative to that scale, not to d2 itself.
    scale = (qs ** 2).sum(-1, keepdims=True) + (t ** 2).sum(-1).max()
    d2_close = np.abs(td2 - jd2) <= 1e-5 * scale
    assert d2_close[valid].all()
    # Summation order can swap two targets whose d2 agree to that
    # tolerance; any other index mismatch is a fault.
    same = tidx == jidx
    assert same[valid].mean() >= 0.999
    assert d2_close[valid & ~same].all()


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_matches_pallas_reference_on_edge_cases(name):
    """Tolerance of ``test_plain_matches_pallas_reference``: indices equal
    but for near-ties within 1e-5 of the distance scale; here over every
    lane, the exhausted ones (d2 ~ 1e30) included."""
    import jax.numpy as jnp

    from velo_tpu.pallas.dist_topk import dist_topk as jax_dist_topk

    t, tm, qs, bf = _edge_problem(name)
    jd2, jidx = (np.asarray(x) for x in jax_dist_topk(
        jnp.asarray(t), jnp.asarray(tm), jnp.asarray(qs), k=16,
        bin_factor=bf, interpret=True))
    td2, tidx = (x.numpy() for x in dist_topk(
        torch.tensor(t), torch.tensor(tm), torch.tensor(qs), k=16,
        bin_factor=bf))
    assert td2.shape == jd2.shape == (len(qs), 16)
    live = jd2 <= 1e20
    np.testing.assert_array_equal(td2 <= 1e20, live)
    scale = (qs ** 2).sum(-1, keepdims=True) + (t ** 2).sum(-1).max()
    d2_close = np.abs(td2 - jd2) <= 1e-5 * scale
    assert d2_close[live].all()
    same = tidx == jidx
    assert d2_close[live & ~same].all()
    if name == "few_live":
        # At most 10 live bins: the other rounds return one bin again and
        # again, the same one in both, with d2 = 1e30 exactly.
        assert live.sum(1).max() <= 10
        assert same.all()
        assert (np.diff(tidx[:, 10:], axis=1) == 0).all()
        assert (td2[~live] == np.float32(1e30)).all()
    elif name == "duplicates":
        # Of two identical targets the lower index wins, wherever the twin
        # lies: no returned index is the later copy of a pair.
        assert same.mean() >= 0.999
        later = np.zeros(len(t), bool)
        later[1:768:2] = True
        later[768:1536] = True
        assert not later[tidx[:, 0]].any() and not later[jidx[:, 0]].any()
    else:
        assert same.mean() >= 0.999


@pytest.mark.parametrize("n,q,bf", [(3072, 1000, 4), (4096, 512, 16)])
def test_plain_recall_and_distances(n, q, bf):
    t, tm, qs = _problem(7 + n, q, n)
    d2, idx = (x.numpy() for x in dist_topk_reference(
        torch.tensor(t), torch.tensor(tm), torch.tensor(qs), k=16,
        bin_factor=bf))
    D, exact_idx = _exact(t, tm, qs, 16)
    recall = np.mean([len(set(idx[i]) & set(exact_idx[i])) / 16
                      for i in range(q)])
    assert recall > 0.97, recall
    assert np.mean(idx[:, 0] == exact_idx[:, 0]) > 0.995
    d2_true = np.take_along_axis(D, idx, 1)
    assert np.abs(d2 - d2_true).max() < 1e-2
    assert np.all(np.diff(d2, axis=1) >= -1e-3)


def test_plain_masked_targets_never_returned():
    rng = np.random.default_rng(11)
    n, q = 1024, 256
    t = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    tm = np.zeros(n, bool)
    tm[: n // 8] = True  # only the first 128 targets are real
    qs = rng.uniform(-5, 5, (q, 3)).astype(np.float32)
    d2, idx = (x.numpy() for x in dist_topk_reference(
        torch.tensor(t), torch.tensor(tm), torch.tensor(qs), k=16,
        bin_factor=4))
    real = d2 < 1e20
    assert real.any()
    assert np.all(tm[idx[real]])


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    t, tm, qs = _problem(3, 256, 1024)
    before = _launches()
    a = dist_topk(torch.tensor(t), torch.tensor(tm), torch.tensor(qs), k=8,
                  bin_factor=4)
    b = dist_topk_reference(torch.tensor(t), torch.tensor(tm),
                            torch.tensor(qs), k=8, bin_factor=4)
    assert _launches() == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,bf", FULL_PATH + SMOOTH_PATH)
def test_kernel_bitwise_equals_plain_on_card(q, n, bf):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    t, tm, qs = (torch.tensor(x, device=dev) for x in _problem(n, q, n))
    before = _launches()
    d2, idx = dist_topk(t, tm, qs, k=16, bin_factor=bf)
    rd2, ridx = dist_topk_reference(t, tm, qs, k=16, bin_factor=bf)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert torch.equal(idx, ridx)
    assert torch.equal(d2, rd2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_kernel_bitwise_equals_plain_on_card_edge_cases(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    t, tm, qs, bf = _edge_problem(name)
    t, tm, qs = (torch.tensor(x, device=dev) for x in (t, tm, qs))
    d2, idx = dist_topk(t, tm, qs, k=16, bin_factor=bf)
    rd2, ridx = dist_topk_reference(t, tm, qs, k=16, bin_factor=bf)
    torch.cuda.synchronize()
    assert d2.shape == (len(qs), 16)
    assert torch.equal(idx, ridx)
    assert torch.equal(d2, rd2)
    if name == "few_live":
        assert bool((d2[:, 10:] == 1e30).all())


@pytest.mark.cuda
def test_kernel_takes_strided_inputs_on_card():
    """A column slice of a wider tensor and a strided mask go to the kernel
    as they are (no copy) and give the contiguous call's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    t, tm, qs = (torch.tensor(x, device=dev) for x in _problem(5, 300, 1024))
    wide_t = torch.cat([t, torch.zeros_like(t)], dim=1)[:, :3]
    wide_q = torch.cat([qs, torch.zeros_like(qs)], dim=1)[:, :3]
    tm2 = torch.stack([tm, ~tm], dim=1)[:, 0]
    assert not wide_t.is_contiguous() and not tm2.is_contiguous()
    a = dist_topk(wide_t, tm2, wide_q, k=16, bin_factor=4)
    b = dist_topk(t, tm, qs, k=16, bin_factor=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,bf", FULL_PATH)
@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_vmapped_kernel_is_one_batched_launch_on_card(q, n, bf, shared,
                                                      monkeypatch):
    """Under torch.func.vmap (four sequences, targets batched or shared at
    batch stride 0) a call is one launch, each sequence's result is the
    unbatched launch's and the plain version's to the bit, and the plain
    version is never reached on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from velo_tpu_torch.kernels import dist_topk as dtk

    dev = torch.device("cuda")
    probs = [_problem(n + b, q, n) for b in range(4)]
    t, tm, qs = (torch.tensor(np.stack(x), device=dev) for x in zip(*probs))

    def plain_reached(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    before = _launches()
    with monkeypatch.context() as m:
        m.setattr(dtk, "dist_topk_reference", plain_reached)
        if shared:
            d2, idx = torch.func.vmap(
                lambda x: dist_topk(t[0], tm[0], x, 16, bf))(qs)
        else:
            d2, idx = torch.func.vmap(
                lambda a, b, c: dist_topk(a, b, c, 16, bf))(t, tm, qs)
        torch.cuda.synchronize()
    assert _launches() == before + 1
    assert d2.shape == idx.shape == (4, q, 16)
    for b in range(4):
        j = 0 if shared else b
        one = dist_topk(t[j], tm[j], qs[b], k=16, bin_factor=bf)
        ref = dist_topk_reference(t[j], tm[j], qs[b], k=16, bin_factor=bf)
        assert torch.equal(d2[b], one[0]) and torch.equal(idx[b], one[1])
        assert torch.equal(d2[b], ref[0]) and torch.equal(idx[b], ref[1])


# The H100: 132 SMs, 232,448 bytes of shared memory for one block.
SMS, MAX_SMEM = 132, 232448


def _smem(tq, nb):
    """Per query 32 columns of bins at an odd stride, 4 bytes a bin."""
    return 4 * tq * 32 * (-(-nb // 32) | 1)


def _check_geometry(q, n, bf, k):
    g = launch_geometry(q, n, bf, k)
    assert n % g.tn == 0 and g.tn % g.nbt == 0 and g.tn // g.nbt == bf
    assert g.nb == n // bf == (n // g.tn) * g.nbt
    assert g.tq in (1, 2, 4, 8) and g.tq * 32 <= g.threads <= 1024
    assert g.blocks == -(-q // g.tq) and g.blocks * g.tq >= q
    assert 4 * g.tq * g.nb <= g.smem_bytes == _smem(g.tq, g.nb) <= MAX_SMEM
    return g


@pytest.mark.parametrize("q,n,bf", FULL_PATH + SMOOTH_PATH + TINY_PATH
                         + [(1000, 3072, 4)])
def test_launch_geometry_on_the_path(q, n, bf):
    from velo_tpu.pallas.dist_topk import _pick_tile

    g = _check_geometry(q, n, bf, 16)
    assert g.tn == _pick_tile(n)  # the reference's tiles decide the bins
    if q >= 1000:
        assert g.blocks >= SMS
        # Two blocks fit one SM's shared memory, so the grid is one wave.
        assert 2 * g.smem_bytes <= MAX_SMEM and g.blocks <= 2 * SMS


@pytest.mark.parametrize("w", range(1, 13))
def test_launch_geometry_of_every_smoother_window(w):
    """A half-window of W frames gives (2W+1) x 3072 edge and (2W+1) x 6144
    planar targets at 64 x 2048, all multiples of 256 that ``dense_nn.knn``
    sends to the kernel: each gets a checked geometry with the reference's
    tile, or the ValueError; none reaches the kernel unchecked."""
    from velo_tpu.pallas.dist_topk import _pick_tile

    for q, per_frame in ((1024, 3072), (2048, 6144)):
        n = (2 * w + 1) * per_frame
        bf = 32 if n >= 16384 else 4  # dense_nn.knn's rule
        assert n % 256 == 0 and n >= 16 * 16
        if _smem(1, n // bf) > MAX_SMEM:
            with pytest.raises(ValueError):
                launch_geometry(q, n, bf, 16)
            continue
        g = _check_geometry(q, n, bf, 16)
        assert g.tn == _pick_tile(n) and g.blocks >= SMS


def test_launch_geometry_sweep():
    seen = set()
    for n in (256, 512, 768, 1024, 3072, 4096, 6144, 12288, 16384, 32768,
              65536, 131072):
        for bf in (1, 2, 4, 8, 16, 32, 64, 256):
            for q in (1, 7, 131, 132, 263, 264, 1000, 1056, 4096, 100000):
                for k in (1, 16, 33):
                    tn = next(t for t in (4096, 3072, 2048, 1024, 512, 256)
                              if n % t == 0)
                    if tn % bf or k > n // bf or _smem(1, n // bf) > MAX_SMEM:
                        with pytest.raises(ValueError):
                            launch_geometry(q, n, bf, k)
                        continue
                    g = _check_geometry(q, n, bf, k)
                    seen.add(g.tq)
                    # The largest query tile that still covers the SMs.
                    bigger = [t for t in (2, 4, 8) if t > g.tq
                              and _smem(t, g.nb) <= MAX_SMEM]
                    assert all(-(-q // t) < SMS for t in bigger)
    assert seen == {1, 2, 4, 8}


@pytest.mark.parametrize("q,n,bf,k", [
    (0, 3072, 4, 16),  # no query
    (256, 1000, 4, 16),  # N no multiple of 256
    (256, 3072, 5, 16),  # the fold does not divide the tile
    (256, 3072, 0, 16),
    (256, 3072, 4, 0),
    (256, 1024, 256, 16),  # fewer bins than k
    (256, 262144, 4, 16),  # one query's bins exceed a block's shared memory
])
def test_launch_geometry_refuses_what_the_kernel_does_not_take(q, n, bf, k):
    with pytest.raises(ValueError):
        launch_geometry(q, n, bf, k)
