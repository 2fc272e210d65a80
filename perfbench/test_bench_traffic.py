"""Each traffic loop gives the same sequence for a seed, and the
reference's pieces (a filtered band, the PNG decoder, the orbit replay)
agree with what they stand in for."""
import numpy as np
import pytest
import torch

from perfbench.conftest import CELLS, tiny_cell
from perfbench import harness
from perfbench.reference import compare


def _run(name, seed):
    cell = tiny_cell(name)
    loop = harness.loop_class(cell)(cell, seed, torch.device("cpu"))
    loop.setup()
    for _ in range(7):
        loop.unit({}, harness.Spans())
    loop.release()
    return loop, loop.outputs()


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_sequence(name):
    (a, out_a), (b, out_b) = _run(name, 2**31 + 9), _run(name, 2**31 + 9)
    for k in out_a:
        va, vb = out_a[k], out_b[k]
        assert (torch.equal(va, vb) if torch.is_tensor(va) else va == vb), k


def test_viewer_drags_follow_the_seed():
    cell = tiny_cell("cornell_mirror.viewer")
    loop_class = harness.loop_class(cell)
    one, same, other = (loop_class(cell, s, torch.device("cpu"))
                        for s in (3, 3, 4))
    frames = range(5 * cell["traffic"]["session"])
    seq = [one.drag(f) for f in frames]
    assert seq == [same.drag(f) for f in frames]
    assert seq != [other.drag(f) for f in frames]
    # every session applies each drag once, only in its first frames
    s, m = cell["traffic"]["session"], cell["traffic"]["moving"]
    assert all((d is None) == (f % s >= m) for f, d in zip(frames, seq))


def test_frames_rows_follow_the_seed():
    cell = tiny_cell("lights_and_quadrics.render")
    loop_class = harness.loop_class(cell)
    rows = [loop_class(cell, s, torch.device("cpu")).rows for s in (5, 5)]
    assert np.array_equal(*rows)
    m = cell["traffic"]["filter_margin"]
    assert rows[0].min() >= m and rows[0].max() < cell["traffic"]["size"] - m


def test_filter_of_a_band_is_the_images_row():
    """The Gaussian window of a band 2 rows either side of a row gives
    that row of the whole image's (the frames loop checks such bands)."""
    img = torch.rand(3, 12, 10, generator=torch.Generator().manual_seed(1))
    full = compare.display(img, "gaussian")
    for i in (2, 5, 9):
        band = compare.display(img[:, i - 2:i + 3], "gaussian")
        assert torch.equal(band[:, 2], full[:, i])


def test_png_decode_reads_both_encoders():
    from sail_tpu_torch.utils import imageio
    img = np.random.default_rng(0).random((9, 7, 3), dtype=np.float32)
    u8 = compare.to_uint8(img)
    assert np.array_equal(compare.png_decode(imageio._png_bytes_py(u8)), u8)
    levels = compare.png_decode(imageio.png_bytes(img)).astype(int) - u8
    assert np.abs(levels).max() <= 3


def test_orbit_replay_is_the_controls():
    import sail_tpu_torch
    from sail_tpu_torch.render.control import Control
    from perfbench import scene_data
    cell = tiny_cell("cornell_mirror.viewer")
    scene = scene_data.make_scene(cell["config"]["scene"], sail_tpu_torch)
    ctl = Control(scene, 16, 16, device="cpu")
    moves = [(4, 0), (-6, -1), (3, 2), (200, 400)]
    for m in moves:
        ctl.orbit(*m)
    eye, center = cell["config"]["scene"]["camera"]
    assert tuple(scene.camera.eye) == compare.orbit_eye(eye, center, moves)
