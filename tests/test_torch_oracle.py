"""The port's copies of the JAX package's numpy and struct pieces, and its
device uint8 resize, against the originals on the CPU:

  * `vertical_jump_pair` and `quadratic_pair` byte-equal;
  * `write_synthetic_video`: the same offsets and the same decoded frames
    (the mp4 files themselves are byte-equal too: one writer, one seed);
  * `patch_rotation` and `patch_vfr` write the same bytes on the same mp4;
  * `resize_u8_cv` and `resize_frame_u8` byte-equal to the JAX versions on
    random uint8 frames, (H, W), (H, W, 3) and channels_last=False, at odd
    downscales and the identity size.

The tests that need cv2 (the mp4 writer) skip where it is missing.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from optical_flow_tpu.oracle import mp4edit as jmp4
from optical_flow_tpu.oracle import synthetic as jsyn
from optical_flow_tpu.ops import resize as jresize
from optical_flow_tpu_torch.oracle import mp4edit as tmp4
from optical_flow_tpu_torch.oracle import synthetic as tsyn
from optical_flow_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("h,w,seed", [(72, 129, 13), (1080, 1920, 13), (37, 53, 2)])
def test_vertical_jump_pair_byte_equal(h, w, seed):
    for a, b in zip(tsyn.vertical_jump_pair(h, w, seed=seed),
                    jsyn.vertical_jump_pair(h, w, seed=seed)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_vertical_jump_pair_jumps_the_strips():
    f1, f2 = tsyn.vertical_jump_pair(1080, 1920)
    np.testing.assert_array_equal(f2[399:480], f1[359:440])      # dy 40
    np.testing.assert_array_equal(f2[496:577], f1[392:473])      # dy 104
    np.testing.assert_array_equal(f2[:399], f1[:399])
    np.testing.assert_array_equal(f2[577:], f1[577:])


@pytest.mark.parametrize("h,w,d", [(64, 96, (0.5, -0.3)), (33, 47, (1.25, 0.75))])
def test_quadratic_pair_byte_equal(h, w, d):
    for a, b in zip(tsyn.quadratic_pair(h, w, d), jsyn.quadratic_pair(h, w, d)):
        np.testing.assert_array_equal(a, b)


def _decode(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.fixture
def videos(tmp_path):
    """The same clip written by the port's and by the JAX writer."""
    pytest.importorskip("cv2")
    port, ref = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    offs = tsyn.write_synthetic_video(port, n_frames=12, h=48, w=64, fps=25.0, seed=5)
    ref_offs = jsyn.write_synthetic_video(ref, n_frames=12, h=48, w=64, fps=25.0, seed=5)
    return port, ref, offs, ref_offs


def test_write_synthetic_video_matches_jax(videos):
    port, ref, offs, ref_offs = videos
    assert offs == ref_offs and len(offs) == 12
    got, want = _decode(port), _decode(ref)
    assert got.shape == (12, 48, 64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clockwise90", [True, False])
def test_patch_rotation_writes_jax_bytes(videos, tmp_path, clockwise90):
    src = videos[1]
    tmp4.patch_rotation(src, str(tmp_path / "t.mp4"), clockwise90)
    jmp4.patch_rotation(src, str(tmp_path / "j.mp4"), clockwise90)
    got = (tmp_path / "t.mp4").read_bytes()
    assert got == (tmp_path / "j.mp4").read_bytes()
    assert got != (tmp_path / "jax.mp4").read_bytes()


def test_patch_vfr_writes_jax_bytes(videos, tmp_path):
    src = videos[1]
    tmp4.patch_vfr(src, str(tmp_path / "t.mp4"))
    jmp4.patch_vfr(src, str(tmp_path / "j.mp4"))
    got = (tmp_path / "t.mp4").read_bytes()
    assert got == (tmp_path / "j.mp4").read_bytes()
    assert len(got) == len((tmp_path / "jax.mp4").read_bytes()) + 8


def test_patch_vfr_refuses_a_vfr_input(videos, tmp_path):
    tmp4.patch_vfr(videos[1], str(tmp_path / "once.mp4"))
    with pytest.raises(ValueError, match="single CFR stts run"):
        tmp4.patch_vfr(str(tmp_path / "once.mp4"), str(tmp_path / "twice.mp4"))


RESIZE_CASES = [((97, 131), 64, 48), ((1080, 1920), 129, 72), ((37, 53), 20, 11),
                ((40, 64), 64, 40)]


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("shape,dw,dh", RESIZE_CASES)
def test_resize_u8_cv_byte_equal_to_jax(shape, dw, dh, channels):
    shape = shape if channels is None else (*shape, channels)
    src = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    got = tresize.resize_u8_cv(torch.as_tensor(src), dw, dh)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.resize_u8_cv(
        jnp.asarray(src), dw, dh)))


@pytest.mark.parametrize("shape,dw,dh", RESIZE_CASES)
def test_resize_u8_cv_planes_byte_equal_to_jax(shape, dw, dh):
    """channels_last=False: leading axes are a batch, (H, W) trailing."""
    src = np.random.default_rng(8).integers(0, 256, (3, *shape), dtype=np.uint8)
    got = tresize.resize_u8_cv(torch.as_tensor(src), dw, dh, channels_last=False)
    assert tuple(got.shape) == (3, dh, dw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.resize_u8_cv(
        jnp.asarray(src), dw, dh, channels_last=False)))


def test_resize_u8_cv_matches_the_host_twin():
    from optical_flow_tpu_torch.ops.host import resize_u8_host
    src = np.random.default_rng(9).integers(0, 256, (101, 173, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tresize.resize_u8_cv(torch.as_tensor(src), 129, 76).numpy(),
        resize_u8_host(src, 129, 76))


@pytest.mark.parametrize("shape", [(1080, 1920), (1080, 1920, 3), (97, 131, 3), (40, 64)])
def test_resize_frame_u8_byte_equal_to_jax(shape):
    src = np.random.default_rng(10).integers(0, 256, shape, dtype=np.uint8)
    got = tresize.resize_frame_u8(torch.as_tensor(src), 129)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.resize_frame_u8(
        jnp.asarray(src), 129)))
