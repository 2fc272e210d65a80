"""The port's tools on the CPU.  The many-object benchmark
(`sail_tpu_torch/tools/many_object_bench.py`): `--plain` at 16² runs the
plain version in both modes, the cull leaves the image as it is, no kernel
is launched; without `--plain` and without a card it raises.  The gradient
localiser (`tools/grad_localise.py`): its pixel maps sum to the leaf and
agree pixel by pixel; without a card it raises."""
import json
import sys

import pytest
import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.tools import grad_localise as gl
from sail_tpu_torch.tools import many_object_bench as mob

torch.set_num_threads(1)


def test_plain_sweep_at_16(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["many_object_bench", "--plain",
                                      "--size", "16", "--counts", "4,9",
                                      "--spp", "1", "--bounces", "2",
                                      "--runs", "1"])
    mob.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and "card" not in out
    assert [r["n_spheres"] for r in out["rows"]] == [4, 9]
    assert [r["n_params"] for r in out["rows"]] == [13 * 4 + 47, 13 * 9 + 47]
    for row in out["rows"]:
        assert row["cull_bit_identical"]
        for mode in mob.MODES:
            assert row[mode]["ms"] > 0 and row[mode]["launches"] == 0


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["many_object_bench"])
    with pytest.raises(RuntimeError, match="--plain"):
        mob.main()


def _rows_on_the_cpu(block):
    """K2's block partials as the plain version gives them: each block's
    gradient with the cotangent on that block alone."""
    bx, by = block

    def rows(params, static, g, height, width, spp, seed, sample0,
             bounces, row0, image_height):
        out = []
        for r in range(0, height, by):
            for c in range(0, width, bx):
                mask = torch.zeros(height, width, dtype=torch.bool)
                mask[r:r + by, c:c + bx] = True
                gm = Vec3(*(torch.where(mask, x, 0.0) for x in g))
                out.append(mk.render_grad_block_plain(
                    params, static, gm, height, width, spp, seed, sample0,
                    bounces, row0, image_height))
        return torch.stack(out)
    return rows


def test_localise_splits_a_leaf_into_its_pixels(monkeypatch):
    """grad_localise's pixel maps, with K2's block partials stood in for by
    the plain version's: both sides' maps sum to the leaf's gradient and
    agree pixel by pixel, and the check names a leaf within its bound."""
    monkeypatch.setattr(mk, "GRAD_BLOCK", (3, 2))
    monkeypatch.setattr(mk, "render_grad_rows", _rows_on_the_cpu((3, 2)))
    params, static = scenes.many_spheres(12).pack()
    gen = torch.Generator().manual_seed(0)
    g = Vec3(*(torch.rand(4, 5, generator=gen) for _ in range(3)))
    args = (params, static, g, 4, 5, 1, 0, 0, 2, 1, 8)
    want = mk.render_grad_block_plain(*args)
    leaf = int(want.abs().argmax())
    pixels = gl.k2_pixels(*args)
    assert pixels.shape == (4, 5, params.numel())
    k2, plain = pixels[:, :, leaf].double(), gl.plain_pixels(*args, leaf)
    scale = float(want[leaf].abs())
    assert scale > 0
    torch.testing.assert_close(pixels.sum((0, 1)), want,
                               atol=1e-5 * float(want.abs().max()), rtol=0)
    assert abs(float(plain.sum()) - float(want[leaf])) < 1e-5 * scale
    torch.testing.assert_close(k2, plain, atol=1e-5 * scale, rtol=0)
    out = gl.check(*args, want, want)
    assert out["excess"] == 0 and out["pixels_with_contribution"] > 0
    assert out["leaf_name"].startswith(("objects", "materials", "textures",
                                        "lights", "camera"))


def test_the_pixel_term_widens_a_leaf_one_pixel_carries():
    want = torch.tensor([100.0, 1.0])
    got = torch.tensor([100.0, 1.0 + 5e-4])
    assert float(gl.leaf_excess(got, want)[1]) > 1
    # one pixel carries the whole leaf: PIXEL_RTOL of it
    within = gl.leaf_excess(got, want, torch.tensor([1.0, 1.0]))
    assert float(within[1]) < 1 and float(within[0]) == 0


def test_localise_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["grad_localise"])
    with pytest.raises(SystemExit, match="CUDA"):
        gl.main()


# ------------------------------------------- the profiling path's tools ----

def test_profile_sections_on_the_cpu(tmp_path):
    """`profile_megakernel` with --device cpu: op_count and phases write
    their keys, each stripped image differs from the full one, and the
    JSON file holds what was printed."""
    from sail_tpu_torch.tools import profile_megakernel as prof
    out = tmp_path / "profile.json"
    res = prof.main(["--device", "cpu", "--sections", "op_count,phases",
                     "--size", "8", "--spp", "2", "--bounces", "2",
                     "--iters", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"] == "cpu" and res["card"] is None
    ops = res["sections"]["op_count"]
    assert ops["k2_ops_per_lane_sample"] > ops["k1_ops_per_lane_sample"] > 0
    assert ops["k5a_ops_per_path_bounce"] > 0
    phases = res["sections"]["phases"]
    for key in ("full_ms", "const_rng_ms", "const_texture_ms",
                "no_shadow_scan_ms", "no_nee_ms", "intersect_only_ms",
                "intersect_only_spp1_ms", "rng_cost_ms", "texture_cost_ms",
                "shadow_scan_cost_ms", "nee_total_cost_ms"):
        assert isinstance(phases[key], float), key
    assert all(phases["stripped_differs_from_full"].values())


def test_profile_vpu_peak_keys_on_the_cpu(monkeypatch):
    """vpu_peak's entries under the JAX tool's keys, on the CPU at small
    geometries (the card's take minutes of the plain version there)."""
    from sail_tpu_torch.tools import profile_megakernel as prof
    monkeypatch.setattr(prof, "ALU_CASES", [
        (key, mix, (2, 8, 2, 3), chains)
        for key, mix, _, chains in prof.ALU_CASES])
    peak = prof.vpu_peak_section(torch.device("cpu"), iters=1)
    assert set(peak) == {"sm_clock_max_mhz", "fma", "fma_tile8x512",
                         "integrator_mix", "integrator_mix_tile8x512",
                         "integrator_mix_tile8x512_ilp8"}
    assert peak["fma"]["fp32_flops"] == 2 * peak["fma"]["ops_counted"]
    assert peak["integrator_mix_tile8x512_ilp8"]["geometry"]["chains"] == 8


def test_profile_without_a_card_raises(monkeypatch):
    from sail_tpu_torch.tools import profile_megakernel as prof
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        prof.main([])


def test_determinism_check_passes_on_the_cpu(tmp_path):
    from sail_tpu_torch.tools import determinism_check as det
    res = det.main(["--device", "cpu", "--size", "16", "--spp", "4",
                    "--bounces", "2", "--out", str(tmp_path / "d.json")])
    assert res["all_pass"], res
    assert {f"tiling_rows{r}_bit_identical" for r in det.TILE_ROWS} <= set(res)
    assert 0 < res["chunking_allclose_rel"] < det.CHUNK_RTOL


def test_occupancy_matches_jax_alive_fractions():
    """occupancy_study's fractions against the JAX package's
    `alive_fractions` on the same scene parameters, rays and noise (the
    mean over samples): equal but for at most one path in 8²·2 (XLA:CPU's
    fused multiply-adds may move a ray across an edge)."""
    import jax.numpy as jnp
    import numpy as np
    from sail_tpu import scenes as jscenes
    from sail_tpu.core import rng as jrng
    from sail_tpu.core.camera import rays_for_pixels as jax_rays
    from sail_tpu.render.integrator import alive_fractions
    from sail_tpu_torch.scene.bridge import (params_from_jax_leaves,
                                             static_from_jax)
    from sail_tpu_torch.tools import occupancy_study as occ
    import jax
    size, spp, bounces = 8, 2, 3
    for _, name in occ.CONFIGS:
        packed, static = getattr(jscenes, name)().pack()
        params = params_from_jax_leaves([np.asarray(x)
                                         for x in jax.tree.leaves(packed)])
        got = [t.numpy() for t in occ.fractions(
            params, static_from_jax(static), size, spp, bounces)]
        ii = jnp.broadcast_to(jnp.arange(size, dtype=jnp.int32)[:, None],
                              (size, size))
        jj = ii.T
        want = np.zeros((2, bounces))
        for s in range(spp):
            noise = jrng.pixel_noise(0, s, ii=ii, jj=jj)
            jx, jy, _ = noise.uniform3(0, jrng.TAG_PIXEL_JITTER)
            ro, rd = jax_rays(packed.camera, ii.astype(jnp.float32),
                              jj.astype(jnp.float32), size, size, jx, jy)
            want += np.asarray(alive_fractions(packed, static, ro, rd, noise,
                                               bounces, occ.WEAK))
        want /= spp
        np.testing.assert_allclose(np.stack(got), want, rtol=0,
                                   atol=1.0 / (size * size * spp))
        assert got[0][0] > 0


def test_occupancy_bounds():
    from sail_tpu_torch.tools import occupancy_study as occ
    assert occ.compaction_bounds([1.0, 1.0], [0.0, 0.0]) == (1.0, 1.0)
    bound, rr = occ.compaction_bounds([0.5, 0.25, 0.1], [0.25, 0.0, 0.0])
    assert bound == 3 / 1.75 and rr == 3 / 1.5


def test_check_finite_names_the_nan_leaf():
    from sail_tpu_torch.utils import sanitize
    tree = {"img": Vec3(torch.ones(2), torch.tensor([1.0, float("nan")]),
                        torch.zeros(2)),
            "grad": torch.zeros(3), "ids": torch.arange(3)}
    with pytest.raises(FloatingPointError, match=r"^scene\.img\.y: 1 "):
        sanitize.check_finite(tree, "scene")
    found = sanitize.check_finite(tree, "scene", raise_error=False)
    assert found == [("scene.img.y", 1)]
    assert sanitize.check_finite({"ok": torch.ones(2)}) == []


def test_assert_bit_equal_and_sanitized():
    from sail_tpu_torch.utils import sanitize
    a = {"x": torch.tensor([0.0, 1.0])}
    sanitize.assert_bit_equal(a, {"x": torch.tensor([0.0, 1.0])}, "t")
    with pytest.raises(AssertionError, match=r"t\.x: 1 differing"):
        sanitize.assert_bit_equal(a, {"x": torch.tensor([-0.0, 1.0])}, "t")
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan|NaN"):
        with sanitize.sanitized():
            torch.sqrt(x).sum().backward()
