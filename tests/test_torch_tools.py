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
    monkeypatch.setattr(mk, "grad_limits", lambda: {"block": (3, 2)})
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
