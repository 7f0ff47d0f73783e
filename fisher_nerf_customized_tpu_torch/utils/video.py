"""An mp4 writer in numpy: H.264 with every macroblock I_PCM, in ISO BMFF.

The JAX package writes its trajectory videos through cv2.VideoWriter.
The machine that runs the port has no cv2 and no ffmpeg, so the file is
made here by hand, as utils/raster.py makes its PNGs:

  stream     H.264 Constrained Baseline (profile_idc 66, constraint flags
             0xC0), CAVLC.  Every picture is an IDR with one I slice
             (consecutive IDRs alternate idr_pic_id 0 and 1), and every
             macroblock is mb_type 25, I_PCM: its 9-bit header, the
             pcm_alignment_zero_bits, then 256 Y, 64 Cb and 64 Cr bytes.
             No transform, no entropy-coded residual, no prediction.
  SPS/PPS    pic_order_cnt_type 2, frame_mbs_only, frame cropping (in
             units of 2) for sizes that are not multiples of 16, no VUI;
             deblocking is switched off in the slice header (at I_PCM's
             qP of 0 it would change no sample anyway).
  colour     BT.601 limited range, which a decoder assumes without a
             VUI; the picture is padded to whole macroblocks by edge
             replication, chroma is the 2x2 mean (4:2:0), and samples are
             rounded and clipped to [1, 255] (early editions of the
             standard forbid 0 in pcm_sample_*).
  level      the smallest whose frame size (in macroblocks, and per
             side) admits the picture.  Raw PCM exceeds every level's
             bit-rate cap; decoders (FFmpeg's among them) do not enforce
             it.
  container  ftyp (isom; isom iso2 avc1 mp41), free, mdat, moov: mvhd and
             one video trak (tkhd with the size in 16.16, mdhd whose
             timescale is the fps and whose duration is the frame count,
             hdlr vide, vmhd, dinf/dref, stbl with an avc1/avcC sample
             entry, stts of one tick a sample, stsc, stsz, and stco or
             co64 once an offset passes 2**32 - 1).  Each sample is the
             slice NAL behind a 4-byte length; the SPS and PPS sit only
             in avcC.  The free box before mdat is taken into a 64-bit
             mdat header when the media data passes 4 GiB.

The file costs about 1.5 bytes a pixel (4:2:0 samples, padded to whole
macroblocks), uncompressed: tens of times cv2's mp4v file of the same
frames.  Each frame's bytes are built with numpy (no loop per sample or
per bit); only the headers are written bit by bit.
"""
from __future__ import annotations

import struct

import numpy as np

MB_HEADER = bytes([0x0D, 0x00])     # ue(25) = 000011010, then 7 zero bits
PCM_MB_BYTES = 256 + 64 + 64
U32_MAX = 0xFFFFFFFF                # past it: co64 and a 64-bit mdat
# (level_idc, MaxFS in macroblocks), Table A-1
_LEVELS = ((10, 99), (11, 396), (20, 396), (21, 792), (22, 1620),
           (30, 1620), (31, 3600), (32, 5120), (40, 8192), (42, 8704),
           (50, 22080), (51, 36864), (60, 139264))
# BT.601, 8-bit RGB to limited-range Y'CbCr
_RGB_TO_YCC = np.array([[65.481, 128.553, 24.966],
                        [-37.797, -74.203, 112.0],
                        [112.0, -93.786, -18.214]]) / 255.0
_YCC_OFFSET = np.array([16.0, 128.0, 128.0])


class _Bits:
    """A big-endian bit writer for the parameter sets and slice header."""

    def __init__(self):
        self.bits: list[str] = []

    def u(self, n: int, v: int):
        self.bits.append(format(v, f"0{n}b"))

    def ue(self, v: int):
        code = format(v + 1, "b")
        self.bits.append("0" * (len(code) - 1) + code)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self, stop: bool) -> bytes:
        """The bits, with a stop bit first if `stop` (rbsp_trailing_bits),
        zero-padded to a whole byte."""
        s = "".join(self.bits) + ("1" if stop else "")
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def emulation_prevent(rbsp: np.ndarray) -> np.ndarray:
    """The NAL payload of an RBSP (uint8): 0x03 inserted before every
    byte <= 3 that follows two zero bytes, counting the zeros anew after
    each insertion (7.4.1)."""
    rbsp = np.asarray(rbsp, np.uint8)
    zero = rbsp == 0
    if not (zero[:-1] & zero[1:]).any():
        return rbsp
    idx = np.arange(rbsp.size)
    last_nz = np.maximum.accumulate(np.where(zero, -1, idx))
    prev_nz = np.concatenate([[-1], last_nz[:-1]])
    zeros_before = idx - prev_nz - 1   # the zero bytes just before each
    hit = (zeros_before >= 2) & (zeros_before % 2 == 0) & (rbsp <= 3)
    return np.insert(rbsp, np.flatnonzero(hit), 3)


def even_size(h: int, w: int) -> tuple[int, int]:
    """The coded size of an (h, w) frame: each side floored to even, as
    cv2's mp4v writer stores it."""
    return h - h % 2, w - w % 2


def yuv420_planes(rgb: np.ndarray):
    """The (Y, Cb, Cr) uint8 planes that the writer stores for an (H, W, 3)
    uint8 RGB frame (H and W even): padded by edge replication to whole
    macroblocks, Y (16 * mb_h, 16 * mb_w), Cb and Cr at half that size."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rgb = np.pad(rgb, ((0, -h % 16), (0, -w % 16), (0, 0)), mode="edge")
    rgb = rgb.astype(np.float64)
    y = rgb @ _RGB_TO_YCC[0] + _YCC_OFFSET[0]
    # the 2x2 mean of each chroma plane: the chroma of the 2x2 mean
    mean = (rgb[0::2, 0::2] + rgb[0::2, 1::2] + rgb[1::2, 0::2]
            + rgb[1::2, 1::2]) * 0.25
    c = mean @ _RGB_TO_YCC[1:].T + _YCC_OFFSET[1:]

    def q(x):
        return np.clip(np.rint(x), 1, 255).astype(np.uint8)
    return q(y), q(c[..., 0]), q(c[..., 1])


def _level_idc(mb_w: int, mb_h: int) -> int:
    for idc, max_fs in _LEVELS:
        side = (8 * max_fs) ** 0.5
        if mb_w * mb_h <= max_fs and mb_w <= side and mb_h <= side:
            return idc
    raise ValueError(f"a {16 * mb_w}x{16 * mb_h} picture exceeds every "
                     f"H.264 level")


def parameter_sets(h: int, w: int) -> tuple[bytes, bytes]:
    """The SPS and PPS NAL units (header byte included) for an h x w
    picture (h, w even)."""
    mb_w, mb_h = -(-w // 16), -(-h // 16)
    b = _Bits()
    b.u(8, 66)                          # profile_idc: Baseline
    b.u(8, 0xC0)                        # constraint_set0/1: Constrained
    b.u(8, _level_idc(mb_w, mb_h))
    b.ue(0)                             # seq_parameter_set_id
    b.ue(0)                             # log2_max_frame_num_minus4
    b.ue(2)                             # pic_order_cnt_type
    b.ue(1)                             # max_num_ref_frames
    b.u(1, 0)                           # gaps_in_frame_num_allowed
    b.ue(mb_w - 1)
    b.ue(mb_h - 1)
    b.u(1, 1)                           # frame_mbs_only_flag
    b.u(1, 1)                           # direct_8x8_inference_flag
    crop_r, crop_b = (16 * mb_w - w) // 2, (16 * mb_h - h) // 2
    b.u(1, int(crop_r > 0 or crop_b > 0))
    if crop_r or crop_b:
        for v in (0, crop_r, 0, crop_b):    # left, right, top, bottom
            b.ue(v)
    b.u(1, 0)                           # vui_parameters_present_flag
    sps = b.align(stop=True)
    b = _Bits()
    b.ue(0)                             # pic_parameter_set_id
    b.ue(0)                             # seq_parameter_set_id
    b.u(1, 0)                           # entropy_coding_mode: CAVLC
    b.u(1, 0)                           # bottom_field_pic_order...
    b.ue(0)                             # num_slice_groups_minus1
    b.ue(0)
    b.ue(0)                             # num_ref_idx_l0/l1_default_minus1
    b.u(1, 0)
    b.u(2, 0)                           # weighted_pred, weighted_bipred
    b.se(0)
    b.se(0)
    b.se(0)                             # pic_init_qp/qs, chroma_qp_offset
    b.u(1, 1)                           # deblocking_filter_control_present
    b.u(1, 0)                           # constrained_intra_pred_flag
    b.u(1, 0)                           # redundant_pic_cnt_present_flag
    pps = b.align(stop=True)
    return tuple(head + emulation_prevent(np.frombuffer(rbsp, np.uint8))
                 .tobytes() for head, rbsp in ((b"\x67", sps), (b"\x68", pps)))


def _slice_head(idr_pic_id: int) -> bytes:
    """The IDR slice header and the first macroblock's mb_type, padded to
    the byte (the padding is its pcm_alignment_zero_bits)."""
    b = _Bits()
    b.ue(0)                             # first_mb_in_slice
    b.ue(7)                             # slice_type: I, all slices
    b.ue(0)                             # pic_parameter_set_id
    b.u(4, 0)                           # frame_num
    b.ue(idr_pic_id)
    b.u(1, 0)                           # no_output_of_prior_pics_flag
    b.u(1, 0)                           # long_term_reference_flag
    b.se(0)                             # slice_qp_delta
    b.ue(1)                             # disable_deblocking_filter_idc
    b.ue(25)                            # mb_type: I_PCM
    return b.align(stop=False)


def slice_nal(planes, idr_pic_id: int) -> bytes:
    """One picture's IDR slice NAL unit from its (Y, Cb, Cr) planes."""
    y, cb, cr = planes
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    n = mb_h * mb_w

    def blocks(p, s):
        return p.reshape(mb_h, s, mb_w, s).swapaxes(1, 2).reshape(n, -1)
    mbs = np.empty((n, 2 + PCM_MB_BYTES), np.uint8)
    mbs[:, :2] = np.frombuffer(MB_HEADER, np.uint8)
    mbs[:, 2:258] = blocks(y, 16)
    mbs[:, 258:322] = blocks(cb, 8)
    mbs[:, 322:] = blocks(cr, 8)
    rbsp = np.concatenate([np.frombuffer(_slice_head(idr_pic_id), np.uint8),
                           mbs.reshape(-1)[2:], [0x80]]).astype(np.uint8)
    return b"\x65" + emulation_prevent(rbsp).tobytes()


def _box(kind: bytes, *payload: bytes) -> bytes:
    data = b"".join(payload)
    return struct.pack(">I", 8 + len(data)) + kind + data


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes):
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(h, w, sps, pps, timescale, delta, sizes, offsets) -> bytes:
    n = len(sizes)
    duration = n * delta
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, timescale, duration), struct.pack(
        ">IH10x", 0x10000, 0x100), _MATRIX, bytes(24), struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIII", 0, 0, 1, 0, duration), bytes(8), struct.pack(
        ">hhhH", 0, 0, 0, 0), _MATRIX, struct.pack(">II", w << 16, h << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))   # 'und'
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide",
                     bytes(12), b"VideoHandler\x00")
    vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    avcc = _box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]),
                struct.pack(">H", len(sps)), sps, b"\x01",
                struct.pack(">H", len(pps)), pps)
    name = b"H.264 I_PCM"
    avc1 = _box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                bytes([len(name)]) + name.ljust(31, b"\0"),
                struct.pack(">Hh", 0x18, -1), avcc)
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), avc1)
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     np.asarray(sizes, ">u4").tobytes())
    wide = len(offsets) > 0 and max(offsets) > U32_MAX
    stco = _full_box(b"co64" if wide else b"stco", 0, 0,
                     struct.pack(">I", n),
                     np.asarray(offsets, ">u8" if wide else ">u4").tobytes())
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


def _timescale(fps) -> tuple[int, int]:
    """(timescale, ticks a frame): the fps itself when it is whole, else
    thousandths of a second."""
    fps = float(fps)
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    if fps.is_integer():
        return int(fps), 1
    return int(round(fps * 1000)), 1000


def write_mp4(path: str, frames, size, fps=10) -> None:
    """Write (H, W, 3) uint8 RGB frames of size (H, W) to `path` as an
    H.264 I_PCM mp4 of `fps` frames a second (no frames: a file with an
    empty track).  Each frame's odd last row and column are dropped
    (even_size)."""
    h, w = even_size(*size)
    if h == 0 or w == 0:
        raise ValueError(f"a {tuple(size)} frame has no even size")
    sps, pps = parameter_sets(h, w)
    timescale, delta = _timescale(fps)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isom", b"iso2", b"avc1", b"mp41")
    sizes, offsets = [], []
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"free"))          # room for a 64-bit mdat header
        mdat_at = f.tell()
        f.write(struct.pack(">I", 0) + b"mdat")
        for i, frame in enumerate(frames):
            if frame.shape != tuple(size) + (3,):
                raise ValueError(f"frame {i} is {frame.shape}, not "
                                 f"{tuple(size) + (3,)}")
            nal = slice_nal(yuv420_planes(frame[:h, :w]), i % 2)
            offsets.append(f.tell())
            f.write(struct.pack(">I", len(nal)) + nal)
            sizes.append(4 + len(nal))
        end = f.tell()
        f.write(_moov(h, w, sps, pps, timescale, delta, sizes, offsets))
        mdat_size = end - mdat_at
        if mdat_size <= U32_MAX:
            f.seek(mdat_at)
            f.write(struct.pack(">I", mdat_size))
        else:                           # free + mdat -> one 64-bit header
            f.seek(mdat_at - 8)
            f.write(struct.pack(">I", 1) + b"mdat"
                    + struct.pack(">Q", mdat_size + 8))
