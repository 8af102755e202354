"""Kernel 6 of the PyTorch port, the fused two-layer MLP
(``qaig_tpu_torch/ops/mlp_fused.py``), and its probe
(``qaig_tpu_torch/scripts/probe_mlp_fused.py``), on the CPU.

The plain version is held against the repo's Pallas kernel
(``scripts/probe_mlp_fused.py::mlp2_fused``, loaded from its file) run in
interpret mode: N 64, D 32, hidden 48 per split, D2 32, tile 16, inputs
from ``np.random.default_rng``, the JAX layouts transposed into the port's.
Tolerances: float32 atol 1e-5 (sums in another order), bf16 atol 2e-2
(one bf16 step at these magnitudes).  The kernel itself runs only on the
card (``tests/test_torch_port_kernels.py``, marked ``cuda``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_probe():
    """The repo's probe script as a module (it imports nothing of the
    port and runs nothing on import)."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_mlp_fused", REPO / "scripts" / "probe_mlp_fused.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _weights(seed, splits, n=64, d=32, hidden=48, d2=32):
    """x and the JAX-layout weights: w0 (D, S*H), w1 (S, H, D2)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, splits * hidden)) * 0.3).astype(
                np.float32),
            rng.standard_normal(splits * hidden).astype(np.float32),
            (rng.standard_normal((splits, hidden, d2)) * 0.3).astype(
                np.float32),
            rng.standard_normal((splits, d2)).astype(np.float32))


def _port_layout(x, w0, b0, w1, b1, dtype):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t(x), t(w0.T), t(b0), t(w1.transpose(0, 2, 1)), t(b1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits,act_last", [(3, False), (1, True)])
def test_reference_matches_pallas_kernel_in_interpret_mode(
        jax_probe, dtype, splits, act_last):
    from qaig_tpu_torch.ops.mlp_fused import mlp2_fused_reference

    arrays = _weights(splits + act_last, splits)
    with pltpu.force_tpu_interpret_mode():
        want = jax_probe.mlp2_fused(
            *(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays),
            act_last=act_last, tile=16)
    got = mlp2_fused_reference(*_port_layout(*arrays,
                                             getattr(torch, dtype)),
                               act_last=act_last)
    assert got.dtype == getattr(torch, dtype) and got.shape == (splits, 64,
                                                                32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])


def test_silu_of_a_partial_sum_is_not_the_function():
    """What the FFN case guards the kernel against: silu applied to each
    hidden chunk's share of the second product instead of to the whole
    sum differs by far more than the tolerance."""
    from qaig_tpu_torch.ops.mlp_fused import mlp2_fused_reference

    x, w0, b0, w1, b1 = _port_layout(*_weights(5, 1), torch.float32)
    want = mlp2_fused_reference(x, w0, b0, w1, b1, act_last=True)
    h = torch.nn.functional.silu(x @ w0.T + b0)
    chunks = [torch.nn.functional.silu(h[:, c:c + 16] @ w1[0][:, c:c + 16].T
                                       + b1[0] / 3) for c in (0, 16, 32)]
    assert (sum(chunks) - want[0]).abs().max() > 100 * TOL["bfloat16"]


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    from qaig_tpu_torch.ops.mlp_fused import mlp2_fused, mlp2_fused_reference

    args = _port_layout(*_weights(6, 3), torch.bfloat16)
    launches = mlp2_fused.launches
    got = mlp2_fused(*args, act_last=False)
    assert mlp2_fused.launches == launches
    assert torch.equal(got, mlp2_fused_reference(*args, act_last=False))


@pytest.mark.parametrize("n,splits,hidden,parts", [
    (8192, 3, 2048, 1), (8192, 1, 2048, 1), (1024, 3, 2048, 2),
    (1024, 1, 2048, 8), (1000, 3, 2048, 2), (1, 1, 2048, 32),
    (77, 2, 192, 3), (130, 1, 64, 1)])
def test_launch_geometry_fills_at_most_one_wave(n, splits, hidden, parts):
    """The hidden chunks are shared out over ``parts`` blocks only while
    the grid stays within the H100's 132 SMs, and the runs cover every
    chunk once."""
    from qaig_tpu_torch.ops.mlp_fused import launch_geometry

    g = launch_geometry(n, splits, hidden, 132)
    assert (g.row_tiles, g.splits, g.parts) == (-(-n // 64), splits, parts)
    chunks = hidden // 64
    assert (g.parts - 1) * g.chunks_per_part < chunks <= (
        g.parts * g.chunks_per_part)
    if g.parts > 1:
        assert g.grid_x * splits * g.parts <= 132


@pytest.mark.parametrize("n", [1, 77, 1000, 1024, 8192, 130, 200, 300])
def test_clusters_cover_every_row_once(n):
    """Row tiles of 64 in clusters of 1, 2 or 4: the grid holds whole
    clusters, every row lies in exactly one block's tile, and the padding
    is less than one cluster (padding blocks hold no row)."""
    from qaig_tpu_torch.ops.mlp_fused import launch_geometry

    g = launch_geometry(n, 3, 2048, 132)
    assert g.cluster in (1, 2, 4) and g.cluster <= g.row_tiles
    assert g.grid_x % g.cluster == 0
    assert 0 <= g.grid_x - g.row_tiles < g.cluster
    owners = np.zeros(n, np.int64)
    for block in range(g.grid_x):
        owners[block * 64:(block + 1) * 64] += 1
    assert (owners == 1).all()
    assert g.row_tiles * 64 - 64 < n <= g.row_tiles * 64


@pytest.mark.parametrize("dim,d2", [(512, 512), (128, 64), (256, 256),
                                    (16, 64), (512, 128), (64, 512)])
def test_shared_memory_of_the_probe_shapes_fits_one_block(dim, d2):
    """Every shape the card tests and the probe launch fits in one block's
    227 KB; D 1536 (a resident x tile of 192 KB) does not."""
    from qaig_tpu_torch.ops.mlp_fused import MAX_SMEM, smem_bytes

    assert smem_bytes(dim, d2) <= MAX_SMEM
    assert smem_bytes(512, 512) == 230_584
    assert smem_bytes(1536, d2) > MAX_SMEM


H100_RESIDENT = {1: 132, 2: 132, 4: 120}   # cudaOccupancyMaxActiveClusters


@pytest.mark.parametrize("n,splits,cluster,parts", [
    (8192, 3, 2, 1), (8192, 1, 2, 1), (1024, 3, 4, 2), (1024, 1, 2, 8),
    (1000, 3, 4, 2), (200, 2, 2, 16), (1, 1, 1, 32)])
def test_cluster_size_follows_the_resident_blocks(n, splits, cluster, parts):
    """With the H100's resident blocks of this kernel (132 alone or in
    pairs, 120 in clusters of 4), clusters of 4 are taken where they add
    no wave: not at 8192 rows (384 blocks: 4 waves of 120 against 3 of
    132; 128 blocks: 2 against 1), but at 1024 rows of packed QKV."""
    from qaig_tpu_torch.ops.mlp_fused import launch_geometry

    g = launch_geometry(n, splits, 2048, H100_RESIDENT)
    assert (g.cluster, g.parts) == (cluster, parts)
    if g.parts > 1:
        assert g.grid_x * splits * g.parts <= H100_RESIDENT[g.cluster]


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_a_fixed_cluster_size_is_taken_where_the_rows_allow_it(cluster):
    """``cluster`` fixes the size (phase 3 times each at 8192 rows); a
    cluster larger than the row tiles is refused."""
    from qaig_tpu_torch.ops.mlp_fused import launch_geometry

    g = launch_geometry(8192, 3, 2048, H100_RESIDENT, cluster)
    assert (g.cluster, g.grid_x, g.parts) == (cluster, 128, 1)
    if cluster > 1:
        with pytest.raises(ValueError, match="no cluster"):
            launch_geometry(64, 1, 2048, H100_RESIDENT, cluster)


@pytest.mark.parametrize("resident,cluster", [(132, 4), (H100_RESIDENT, 2)])
def test_clusters_cut_the_weight_reads_of_packed_qkv(resident, cluster):
    """At the probe's packed QKV and 8192 rows the weights come from L2
    once per cluster: 0.40 GB a call in clusters of 4, 0.81 GB in pairs,
    where 64-row blocks alone would read 1.61 GB."""
    from qaig_tpu_torch.ops.mlp_fused import launch_geometry, weight_l2_bytes

    per_tile = 128 * 3 * 2048 * (512 + 512) * 2
    assert launch_geometry(8192, 3, 2048, resident).cluster == cluster
    got = weight_l2_bytes(8192, 512, 3, 2048, 512, resident)
    assert got * cluster == per_tile


def test_probe_weights_are_the_jax_probes_transposed(jax_probe):
    """``make_weights`` draws the JAX probe's arrays in its order and
    shapes: one layer of the port's kernel chain (plain version, bf16)
    equals the JAX probe's fused chain on the JAX layouts (interpret
    mode)."""
    from qaig_tpu_torch.scripts import probe_mlp_fused as probe

    dim, hidden, n = 32, 64, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, dim)) * 0.05).to(
        torch.bfloat16)
    qkv, ffn = probe.make_weights(rng, 1, dim, hidden, torch.device("cpu"))
    got = probe.kernel_chain(x, qkv, ffn)

    def jax_layout(w0, b0, w1, b1):
        return tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in (w0.T, b0, w1.transpose(1, 2), b1))

    with pltpu.force_tpu_interpret_mode():
        xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        o = jax_probe.mlp2_fused(xj, *jax_layout(*qkv[0]), tile=16)
        g = jax_probe.mlp2_fused(xj, *jax_layout(*ffn[0]), act_last=True,
                                 tile=16)
    want = (o[0] + o[1] + o[2] + g[0]) * 0.25
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL["bfloat16"])


def test_probe_main_runs_on_the_cpu(capsys):
    """The probe end to end at a tiny size: the plain version stands in
    for the kernel, so the two chains agree within bf16 rounding."""
    from qaig_tpu_torch.scripts import probe_mlp_fused as probe

    results = probe.main(device="cpu", rows=(64, 40), layers=2, dim=32,
                         hidden=64, reps=2)
    assert [r["rows"] for r in results] == [64, 40]
    for r in results:
        assert r["max_err"] <= TOL["bfloat16"]
        assert r["hbm_mb_avoided"] == pytest.approx(
            2 * (r["rows"] * 3 * 64 + 2 * r["rows"] * 64) * 2 / 1e6)
        assert r["kernel_ms"] > 0 and r["library_ms"] > 0
    out = capsys.readouterr().out
    for rows in (64, 40):
        assert f"rows={rows}: fused vs library 1-layer max err" in out
        assert f"fused kernel chain      rows={rows} x2 layers" in out
