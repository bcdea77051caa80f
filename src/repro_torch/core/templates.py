"""§6.3 template/macro library: DNN layer -> (layout, ISA program).

Each template returns a ``Mapping`` holding the SRAM image to preload,
the instruction program, and an extractor that reads the result back out
of the machine state — the paper's statement that a template packages
*both* the instruction schedule and the memory layout.

The CONV dataflow is §6.1 exactly: broadcast one kernel tap -> multiply a
whole image row -> multiply-accumulate into R4 -> shift R4 one lane ->
repeat over taps; shift back after each kernel row.  (The paper's
pseudo-code shifts after every tap and then steps back by -(K-1); the
algebra only closes if the shift happens *between* taps — i.e. K-1
shifts — which is what we implement; recorded in DESIGN.md §8.)

§6.2 size mismatches:
  * image wider than the datapath  -> ``partition_image`` (halo duplication)
  * image narrower than the lanes  -> ``pack_width`` (multiple images or
    channels side by side in one VWR row)

These programs are bit-exact (tests/test_isa_conv.py asserts equality
with the NumPy oracle) and their counters cross-validate the closed-form
cost model in core/analysis.py at small sizes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.isa import (BRAN, CALC, GLMV, NOP, PERM, RLB, RMV,
                                  VFUX, VMV, WLB, Instr, ProvetMachine)
from repro_torch.core.machine import ProvetConfig


@dataclass
class Mapping:
    cfg: ProvetConfig
    sram_image: np.ndarray                    # preloaded SRAM contents
    program: List[Instr]
    extract: Callable[[ProvetMachine], np.ndarray]
    meta: Dict = field(default_factory=dict)

    def run(self, dtype=np.float32) -> Tuple[np.ndarray, ProvetMachine]:
        m = ProvetMachine(self.cfg, dtype=dtype)
        m.sram[: self.sram_image.shape[0]] = self.sram_image
        m.run(self.program)
        return self.extract(m), m


def _shift_program(src, dst, step, rng) -> List[Instr]:
    """Split a lane shift larger than the shuffler range into steps
    (§4.3.7: beyond max range by using multiple steps, more cycles)."""
    out: List[Instr] = []
    remaining = step
    cur_src = src
    while remaining != 0:
        s = max(-rng, min(rng, remaining))
        out.append(PERM(src=cur_src, dst=dst, shift=s))
        cur_src = dst
        remaining -= s
    return out


# ======================================================================
# CONV2D (§6.1) — multi-channel, stride 1, 'valid'
# ======================================================================

def conv2d(cfg: ProvetConfig, img: np.ndarray, w: np.ndarray,
           use_mac: bool = True) -> Mapping:
    """img: (C_in, H, W) with W <= vfu_width; w: (C_out, C_in, K, K).

    Output: (C_out, H-K+1, W-K+1).  Single-VFU mapping (n_vfus=1) — the
    multi-VFU case packs channels across VFUs via pack_width.
    """
    assert cfg.n_vfus == 1, "use pack_width for multi-VFU packing"
    C_in, H, W = img.shape
    C_out, C_in2, K, K2 = w.shape
    assert C_in == C_in2 and K == K2
    V = cfg.vfu_width
    S = cfg.n_slices
    assert W <= V, "partition_image first (§6.2.1)"
    H_out, W_out = H - K + 1, W - K + 1

    # ---- SRAM layout ----
    # image: channel c row r -> sram row (c*H + r)//S, slice (c*H + r)%S
    rows_img = -(-C_in * H // S)
    # kernels: flattened (C_out*C_in*K*K) operands, after the image
    k_flat = w.reshape(-1)
    rows_ker = -(-len(k_flat) // cfg.sram_width)
    k_base = rows_img
    # outputs staged after kernels
    out_base = rows_img + rows_ker
    rows_out = -(-C_out * H_out // S)
    depth_needed = out_base + rows_out
    assert depth_needed <= cfg.sram_depth, (
        f"layer needs {depth_needed} SRAM rows > depth {cfg.sram_depth}; "
        "partition the layer (§6.2.1)")

    sram = np.zeros((depth_needed, cfg.sram_width), np.float32)
    for c in range(C_in):
        for r in range(H):
            idx = c * H + r
            sram[idx // S, (idx % S) * V: (idx % S) * V + W] = img[c, r]
    for i, val in enumerate(k_flat):
        sram[k_base + i // cfg.sram_width, i % cfg.sram_width] = val

    # ---- program ----
    P: List[Instr] = []
    rng = cfg.vfu_shuffle_range
    loaded_a = [None]            # sram row currently in VWR0 (image)
    loaded_b = [None]            # sram row currently in VWR1 (kernel)

    def load_a(row):
        if loaded_a[0] != row:
            P.append(RLB(vwr=0, row=row))
            loaded_a[0] = row

    def load_b(row):
        if loaded_b[0] != row:
            P.append(RLB(vwr=1, row=row))
            loaded_b[0] = row

    for co in range(C_out):
        for k_out in range(H_out):
            # zero the accumulator
            P.append(PERM(src="R4", dst="R4", pairs=(), fill=0.0))
            for c in range(C_in):
                for j in range(K):
                    img_idx = c * H + (k_out + j)
                    load_a(img_idx // S)
                    img_slice = img_idx % S
                    for i in range(K):
                        tap = ((co * C_in + c) * K + j) * K + i
                        load_b(k_base + tap // cfg.sram_width)
                        tap_in_row = tap % cfg.sram_width
                        P.append(VMV(vwr=1, slice_idx=tap_in_row // V,
                                     dst="R1",
                                     broadcast=tap_in_row % V))
                        if use_mac:
                            P.append(VFUX(mode="mac", in1="R1",
                                          in2=(0, img_slice), out="R4",
                                          acc="R4"))
                        else:
                            P.append(VFUX(mode="mult", in1="R1",
                                          in2=(0, img_slice), out="R2"))
                            P.append(VFUX(mode="addacc", in1="R2",
                                          out="R4", acc="R4"))
                        if i < K - 1:
                            P.extend(_shift_program("R4", "R4", 1, rng))
                    if K > 1:
                        P.extend(_shift_program("R4", "R4", -(K - 1), rng))
            # write the finished output row back: with only 2 VWRs the
            # image VWR must be borrowed, so this is a read-modify-write
            # of the output SRAM row (RLB + RMV + WLB) — the §4.3.4
            # remark that a single-VWR-per-stream mapping pays extra
            # transactions.  Cost is counted honestly.
            out_idx = co * H_out + k_out
            out_row = out_base + out_idx // S
            load_a(out_row)
            P.append(RMV(vwr=0, slice_idx=out_idx % S, src="R4"))
            P.append(WLB(vwr=0, row=out_row))
            loaded_a[0] = None          # VWR0 no longer holds image data

    def extract(m: ProvetMachine) -> np.ndarray:
        out = np.zeros((C_out, H_out, W_out), np.float32)
        for co_ in range(C_out):
            for r in range(H_out):
                idx = co_ * H_out + r
                row = m.sram[out_base + idx // S]
                out[co_, r] = row[(idx % S) * V: (idx % S) * V + W_out]
        return out

    total_macs = C_out * C_in * K * K * H_out * W_out
    return Mapping(cfg, sram, P, extract,
                   meta={"total_macs": total_macs, "H_out": H_out,
                         "W_out": W_out})


def depthwise_conv2d(cfg: ProvetConfig, img: np.ndarray,
                     w: np.ndarray) -> Mapping:
    """img: (C, H, W); w: (C, K, K) — per-channel conv, no reduction.

    The paper's headline low-reuse case (MobileNet §3.4): every weight is
    used H_out*W_out times only; every activation K^2 times.
    """
    C, H, W = img.shape
    C2, K, _ = w.shape
    assert C == C2
    # a depthwise layer is C independent 1-in/1-out convs sharing layout;
    # express it exactly that way (weights block-diagonal, but without
    # materializing the zero cross terms)
    maps = [conv2d(cfg, img[c: c + 1], w[c][None, None]) for c in range(C)]

    # fuse: concatenate programs; each sub-map has its own SRAM image —
    # rebuild a combined layout instead
    return _fuse_per_channel(cfg, img, w, maps)


def _fuse_per_channel(cfg, img, w, maps) -> Mapping:
    """Run C single-channel convs back-to-back in ONE machine so the
    counters accumulate into a whole-layer total."""
    C, H, W = img.shape
    K = w.shape[-1]
    H_out, W_out = H - K + 1, W - K + 1
    sub = maps[0]
    program: List[Instr] = []
    for c in range(C):
        program.extend(maps[c].program)
    mp = Mapping(cfg, sub.sram_image, program, sub.extract,
                 meta={"total_macs": C * K * K * H_out * W_out,
                       "per_channel": maps})

    def run(dtype=np.float32):
        outs = []
        m = ProvetMachine(cfg, dtype=dtype)
        for c in range(C):
            sm = maps[c]
            m.sram[: sm.sram_image.shape[0]] = sm.sram_image
            # every sub-program re-RLBs its own rows, so stale VWR
            # contents across channels are harmless
            m.run(sm.program)
            outs.append(sm.extract(m)[0])
        return np.stack(outs), m

    mp.run = run  # type: ignore[method-assign]
    return mp


# ======================================================================
# Fully connected (GEMV)
# ======================================================================

def fc(cfg: ProvetConfig, x: np.ndarray, w: np.ndarray) -> Mapping:
    """x: (N_in,); w: (N_out, N_in); out = w @ x. N_out <= vfu_width.

    Streaming case: weights have zero reuse — the architecture's VWR
    ratio N is the *only* thing standing between the VFU and the SRAM
    (§5.1); CMR for FC ~= N * utilization.
    """
    assert cfg.n_vfus == 1
    N_out, N_in = w.shape
    V = cfg.vfu_width
    S = cfg.n_slices
    assert N_out <= V, "pack output neurons / tile first"

    # layout: x in row 0 (first ceil(N_in/W) rows); weight columns
    # w[:, i] padded to V, S columns per SRAM row.
    rows_x = -(-N_in // cfg.sram_width)
    w_base = rows_x
    rows_w = -(-N_in // S)
    out_base = w_base + rows_w
    depth = out_base + 1
    assert depth <= cfg.sram_depth, "tile FC first"

    sram = np.zeros((depth, cfg.sram_width), np.float32)
    sram[:rows_x].reshape(-1)[:N_in] = x
    for i in range(N_in):
        row, sl = w_base + i // S, i % S
        sram[row, sl * V: sl * V + N_out] = w[:, i]

    P: List[Instr] = []
    P.append(PERM(src="R4", dst="R4", pairs=(), fill=0.0))
    loaded_a = [None]
    loaded_b = [None]
    for i in range(N_in):
        xr = i // cfg.sram_width
        if loaded_a[0] != xr:
            P.append(RLB(vwr=0, row=xr))
            loaded_a[0] = xr
        wr = w_base + i // S
        if loaded_b[0] != wr:
            P.append(RLB(vwr=1, row=wr))
            loaded_b[0] = wr
        xi = i % cfg.sram_width
        P.append(VMV(vwr=0, slice_idx=xi // V, dst="R1", broadcast=xi % V))
        P.append(VFUX(mode="mac", in1="R1", in2=(1, i % S), out="R4",
                      acc="R4"))
    P.append(RMV(vwr=0, slice_idx=0, src="R4"))
    P.append(WLB(vwr=0, row=out_base))

    def extract(m: ProvetMachine) -> np.ndarray:
        return m.sram[out_base, :N_out].copy()

    return Mapping(cfg, sram, P, extract,
                   meta={"total_macs": N_out * N_in})


# ======================================================================
# Max pooling (window K, stride K)
# ======================================================================

def maxpool(cfg: ProvetConfig, img: np.ndarray, K: int) -> Mapping:
    """img: (H, W), output (H//K, W//K). Sliding max via VFU shuffler."""
    assert cfg.n_vfus == 1
    H, W = img.shape
    V = cfg.vfu_width
    S = cfg.n_slices
    assert W <= V and H % K == 0 and W % K == 0
    H_out, W_out = H // K, W // K

    rows_img = -(-H // S)
    out_base = rows_img
    sram = np.zeros((out_base + 1 + H_out // S, cfg.sram_width), np.float32)
    for r in range(H):
        sram[r // S, (r % S) * V: (r % S) * V + W] = img[r]

    P: List[Instr] = []
    rng = cfg.vfu_shuffle_range
    NEG = -3.0e38
    loaded = [None]
    for t in range(H_out):
        P.append(PERM(src="R4", dst="R4", pairs=(), fill=NEG))
        for j in range(K):
            r = t * K + j
            if loaded[0] != r // S:
                P.append(RLB(vwr=0, row=r // S))
                loaded[0] = r // S
            # R2 <- row; sliding max over i via shift+maxacc
            P.append(VMV(vwr=0, slice_idx=r % S, dst="R2"))
            P.append(VFUX(mode="maxacc", in1="R2", out="R4", acc="R4"))
            for i in range(1, K):
                P.extend(_shift_program("R2", "R2", -1, rng))
                P.append(VFUX(mode="maxacc", in1="R2", out="R4", acc="R4"))
        # R4[x] now holds max over window starting at x; gather x = K*t
        # (distances may exceed the shuffler range: staged moves)
        P.extend(_gather_strided("R4", "R3", K, W_out, rng))
        out_row = out_base + t // S
        if loaded[0] != out_row:            # read-modify-write staging
            P.append(RLB(vwr=0, row=out_row))
        P.append(RMV(vwr=0, slice_idx=t % S, src="R3"))
        P.append(WLB(vwr=0, row=out_row))
        loaded[0] = None

    def extract(m: ProvetMachine) -> np.ndarray:
        out = np.zeros((H_out, W_out), np.float32)
        for t_ in range(H_out):
            row = m.sram[out_base + t_ // S]
            out[t_] = row[(t_ % S) * V: (t_ % S) * V + W_out]
        return out

    return Mapping(cfg, sram, P, extract,
                   meta={"total_macs": H_out * W_out * K * K})


def _gather_strided(src, dst, K, n, rng) -> List[Instr]:
    """dst[q] = src[K*q] for q < n, emitted as range-legal PERM stages."""
    out: List[Instr] = []
    # stage moves: process in descending distance so sources aren't
    # overwritten; all pairs move left (d < s), multi-step if needed.
    cur = {q: K * q for q in range(n)}
    step = 0
    while any(cur[q] != q for q in cur):
        pairs = []
        for q in range(n):
            s = cur[q]
            d = max(q, s - rng)
            pairs.append((s, d))
            cur[q] = d
        out.append(PERM(src=src if step == 0 else dst, dst=dst,
                        pairs=tuple(pairs), fill=0.0))
        step += 1
    if step == 0:
        out.append(PERM(src=src, dst=dst, shift=0))
    return out


# ======================================================================
# §6.2 size-mismatch handling
# ======================================================================

def partition_image(img: np.ndarray, max_w: int, K: int
                    ) -> List[Tuple[np.ndarray, int]]:
    """§6.2.1: split (C,H,W) into vertical strips of width <= max_w with
    K-1 halo duplication. Returns [(strip, out_col_offset)]."""
    C, H, W = img.shape
    strips = []
    out_w = max_w - K + 1
    x = 0
    while x < W - K + 1:
        strip = img[:, :, x: x + max_w]
        strips.append((strip, x))
        x += out_w
    return strips


def stitch_strips(parts: List[Tuple[np.ndarray, int]], W_out: int
                  ) -> np.ndarray:
    """Reassemble strip conv outputs into the full-width output."""
    C_out, H_out = parts[0][0].shape[:2]
    out = np.zeros((C_out, H_out, W_out), np.float32)
    for arr, off in parts:
        w = min(arr.shape[2], W_out - off)
        out[:, :, off: off + w] = arr[:, :, :w]
    return out


def pack_width(images: List[np.ndarray], lane_width: int, K: int
               ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """§6.2.2: place multiple narrow images side by side in the lanes.

    Each image is padded by K-1 dead lanes so kernels never straddle two
    images. Returns (packed (C,H,W_packed), [(offset, width)]).
    """
    C, H = images[0].shape[:2]
    spans = []
    cols = []
    off = 0
    for im in images:
        w = im.shape[2]
        assert off + w <= lane_width, "images do not fit the lanes"
        spans.append((off, w))
        cols.append(im)
        off += w + (K - 1)          # dead zone between images
    packed = np.zeros((C, H, min(off, lane_width)), np.float32)
    for (o, w), im in zip(spans, cols):
        packed[:, :, o: o + w] = im
    return packed, spans
