"""write_trajectory_video: the port's mp4 (utils/video.py, H.264 I_PCM in
ISO BMFF, numpy only) against the JAX package's cv2 mp4v file.

Both files are decoded with cv2 (FFmpeg) here: the same frame count,
size and fps; the port's frames within max |d| <= 16 and mean |d| <= 2.5
of the input, and no further from it on average than the JAX package's.
The colour error is the 4:2:0 conversion's (each 2x2 block shares one
chroma sample); the test frames' colour varies over more than a few
pixels (the noise is blurred), as a render's does.  Without cv2,
chip_smoke.py's own reader (the one the card's machine runs) reads the
port's file back: every Y, Cb and Cr plane equals the writer's colour
conversion byte for byte, and the boxes say what was written.
"""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from fisher_nerf_customized_tpu.engine.visualization import (
    write_trajectory_video as jax_write)
from fisher_nerf_customized_tpu_torch.engine.visualization import (
    write_trajectory_video)
from fisher_nerf_customized_tpu_torch.utils import video

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SIZES = [(48, 64), (130, 250), (47, 63), (256, 256)]
MAX_ERR, MEAN_ERR = 16, 2.5


def float_frames(h, w, seed=0):
    """A smooth gradient, two blurred noises, an all-black frame and a
    gray frame of values 0-3, as float RGB in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = [np.stack([xx / (w - 1), yy / (h - 1), (xx + yy) / (h + w - 2)],
                    -1)]
    for _ in range(2):
        n = ndimage.gaussian_filter(rng.random((h, w, 3)), (6, 6, 0))
        out.append((n - n.min()) / (n.max() - n.min()))
    out.append(np.zeros((h, w, 3)))
    out.append(np.repeat(rng.integers(0, 4, (h, w, 1)), 3, -1) / 255.0)
    return out


def as_uint8(frames):
    return [np.clip(f * 255, 0, 255).astype(np.uint8) for f in frames]


def decode(path):
    """cv2's reading of a file: (count, width, height, fps) and the RGB
    frames."""
    cap = cv2.VideoCapture(str(path))
    info = tuple(cap.get(p) for p in (cv2.CAP_PROP_FRAME_COUNT,
                                      cv2.CAP_PROP_FRAME_WIDTH,
                                      cv2.CAP_PROP_FRAME_HEIGHT,
                                      cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return info, frames


def errors(written, decoded):
    h, w = decoded[0].shape[:2]
    return [np.abs(d.astype(np.int64) - f[:h, :w]) for f, d in
            zip(written, decoded)]


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decodes_as_the_jax_file(tmp_path, size, dtype):
    h, w = size
    frames = float_frames(h, w)
    inputs = as_uint8(frames) if dtype == "uint8" else frames
    written = as_uint8(frames)
    jax_write(inputs, str(tmp_path / "jax.mp4"))
    write_trajectory_video(inputs, str(tmp_path / "port.mp4"))
    j_info, j_frames = decode(tmp_path / "jax.mp4")
    p_info, p_frames = decode(tmp_path / "port.mp4")
    assert p_info == j_info == (len(frames), w - w % 2, h - h % 2, 10.0)
    assert len(p_frames) == len(j_frames) == len(frames)
    p_err, j_err = errors(written, p_frames), errors(written, j_frames)
    for e in p_err:
        assert e.max() <= MAX_ERR and e.mean() <= MEAN_ERR
    assert np.mean(p_err) <= np.mean(j_err)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reader_recovers_the_planes(tmp_path, size):
    h, w = size
    frames = as_uint8(float_frames(h, w, seed=1))
    path = tmp_path / "v.mp4"
    write_trajectory_video(frames, str(path), fps=15)
    got = chip_smoke.read_pcm_mp4(str(path))
    eh, ew = h - h % 2, w - w % 2
    assert (got["height"], got["width"]) == (eh, ew)
    assert len(got["frames"]) == len(frames)
    for f, planes in zip(frames, got["frames"]):
        want = video.yuv420_planes(f[:eh, :ew])
        for a, b in zip(planes, want):
            assert a.shape == b.shape and np.array_equal(a, b)
    # the samples: limited-range luma, and no start-code prefix in a NAL
    y = np.concatenate([p[0].ravel() for p in got["frames"]])
    assert 16 <= y.min() and y.max() <= 235
    data = path.read_bytes()
    for off, size_ in zip(got["offsets"], got["sizes"]):
        nal = np.frombuffer(data[off + 4:off + size_], np.uint8)
        prefix = (nal[:-2] == 0) & (nal[1:-1] == 0) & (nal[2:] <= 2)
        assert not prefix.any()
    assert got["idr_pic_ids"] == [i % 2 for i in range(len(frames))]


def test_box_layout(tmp_path):
    frames = as_uint8(float_frames(48, 64))
    path = tmp_path / "v.mp4"
    write_trajectory_video(frames, str(path), fps=15)
    data = path.read_bytes()
    top = chip_smoke.mp4_boxes(data)
    assert [k for k, _, _ in top] == ["ftyp", "free", "mdat", "moov"]
    s, e = top[0][1:]
    assert data[s:e] == (b"isom" + (0x200).to_bytes(4, "big")
                         + b"isomiso2avc1mp41")
    moov = chip_smoke.mp4_box(data, 0, len(data), "moov")
    assert [k for k, _, _ in chip_smoke.mp4_boxes(data, *moov)] == \
        ["mvhd", "trak"]
    stbl = chip_smoke.mp4_box(data, *moov, "trak", "mdia", "minf", "stbl")
    assert [k for k, _, _ in chip_smoke.mp4_boxes(data, *stbl)] == \
        ["stsd", "stts", "stsc", "stsz", "stco"]
    got = chip_smoke.read_pcm_mp4(str(path))
    n = len(frames)
    assert (got["timescale"], got["duration"], got["stts"]) == (15, n,
                                                                [(n, 1)])
    assert len(got["sizes"]) == n and not got["wide_offsets"]
    assert (got["profile"], got["constraints"], got["level"]) == (66, 0xC0,
                                                                  10)
    assert got["n_bytes"] == len(data)


def test_empty_list_makes_nothing(tmp_path):
    for write in (jax_write, write_trajectory_video):
        path = tmp_path / "sub" / "v.mp4"
        assert write([], str(path)) is None
        assert not (tmp_path / "sub").exists()


def test_odd_frames_are_skipped_as_cv2_skips_them(tmp_path):
    frames = as_uint8(float_frames(48, 64))
    mixed = [frames[0], frames[1][:32], frames[2][..., 0],
             np.concatenate([frames[3], frames[3][..., :1]], -1), frames[4]]
    jax_write(mixed, str(tmp_path / "jax.mp4"))
    with pytest.warns(UserWarning, match="skipped") as caught:
        write_trajectory_video(mixed, str(tmp_path / "port.mp4"))
    assert len(caught) == 3
    j_info, _ = decode(tmp_path / "jax.mp4")
    p_info, p_frames = decode(tmp_path / "port.mp4")
    assert p_info == j_info and p_info[0] == 2 == len(p_frames)
    got = chip_smoke.read_pcm_mp4(str(tmp_path / "port.mp4"))
    for f, planes in zip([frames[0], frames[4]], got["frames"]):
        assert all(np.array_equal(a, b) for a, b in
                   zip(planes, video.yuv420_planes(f)))


def test_tensors_write_the_numpy_file(tmp_path):
    frames = float_frames(48, 64)
    write_trajectory_video(frames, str(tmp_path / "np.mp4"))
    write_trajectory_video([torch.tensor(f, dtype=torch.float32,
                                         requires_grad=True)
                            for f in frames], str(tmp_path / "t.mp4"))
    write_trajectory_video([torch.from_numpy(f) for f in as_uint8(frames)],
                           str(tmp_path / "u8.mp4"))
    ref = (tmp_path / "np.mp4").read_bytes()
    assert (tmp_path / "u8.mp4").read_bytes() == ref
    # float32 rounding may move a truncated sample by one
    got = chip_smoke.read_pcm_mp4(str(tmp_path / "t.mp4"))["frames"]
    want = chip_smoke.read_pcm_mp4(str(tmp_path / "np.mp4"))["frames"]
    for a, b in zip(got, want):
        assert all(np.abs(x.astype(int) - y).max() <= 1 for x, y in zip(a, b))


def test_64_bit_offsets_and_mdat(tmp_path, monkeypatch):
    frames = as_uint8(float_frames(48, 64))
    write_trajectory_video(frames, str(tmp_path / "narrow.mp4"))
    monkeypatch.setattr(video, "U32_MAX", 1000)
    write_trajectory_video(frames, str(tmp_path / "wide.mp4"))
    data = (tmp_path / "wide.mp4").read_bytes()
    top = chip_smoke.mp4_boxes(data)
    assert [k for k, _, _ in top] == ["ftyp", "mdat", "moov"]
    assert int.from_bytes(data[top[1][1] - 16:top[1][1] - 12], "big") == 1
    got = chip_smoke.read_pcm_mp4(str(tmp_path / "wide.mp4"))
    assert got["wide_offsets"] and max(got["offsets"]) > 1000
    n_info, n_frames = decode(tmp_path / "narrow.mp4")
    w_info, w_frames = decode(tmp_path / "wide.mp4")
    assert w_info == n_info and len(w_frames) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(w_frames, n_frames))


def escape_plain(rbsp: bytes) -> bytes:
    """7.4.1's emulation prevention, one byte at a time."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def test_emulation_prevention():
    cases = [b"", b"\x00", b"\x00\x00", b"\x00\x00\x00", b"\x00\x00\x01",
             b"\x00\x00\x03", b"\x00\x00\x04", b"\x00" * 7 + b"\x02",
             b"\x00\x00\x03\x03\x00\x00\x00\x80"]
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 64, 4096):
        cases.append(rng.choice(np.array([0, 0, 0, 0, 1, 2, 3, 4, 0x80],
                                         np.uint8), n).tobytes())
    for rbsp in cases:
        want = escape_plain(rbsp)
        got = video.emulation_prevent(np.frombuffer(rbsp, np.uint8))
        assert got.tobytes() == want
        assert chip_smoke.unescape(want).tobytes() == rbsp
    assert escape_plain(b"\x00" * 4) == b"\x00\x00\x03\x00\x00"


@pytest.mark.parametrize("size,level", [((48, 64), 10), ((256, 256), 11),
                                        ((1080, 1920), 40),
                                        ((4320, 8192), 60)])
def test_level_admits_the_frame(size, level):
    sps, pps = video.parameter_sets(*size)
    assert sps[:4] == bytes([0x67, 66, 0xC0, level]) and pps[0] == 0x68


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="level"):
        video.parameter_sets(8192, 8192)
    with pytest.raises(ValueError, match="even size"):
        write_trajectory_video([np.zeros((1, 5, 3), np.uint8)],
                               str(tmp_path / "v.mp4"))
    with pytest.raises(ValueError, match="fps"):
        write_trajectory_video([np.zeros((4, 4, 3), np.uint8)],
                               str(tmp_path / "v.mp4"), fps=0)
    assert not (tmp_path / "v.mp4").exists()


def test_fractional_fps(tmp_path):
    frames = as_uint8(float_frames(48, 64))
    jax_write(frames, str(tmp_path / "jax.mp4"), fps=29.97)
    write_trajectory_video(frames, str(tmp_path / "port.mp4"), fps=29.97)
    got = chip_smoke.read_pcm_mp4(str(tmp_path / "port.mp4"))
    assert (got["timescale"], got["stts"]) == (29970, [(len(frames), 1000)])
    assert decode(tmp_path / "port.mp4")[0] == \
        decode(tmp_path / "jax.mp4")[0]
