"""§7 analytical models: Provet vs Eyeriss / TPU / ARA / GPU.

Provet's numbers come from a *closed-form count of the conv template*
(core/templates.py): the same loop structure counted arithmetically.
Property tests assert the closed form matches the ISA interpreter's
counters at small sizes (`issue='scalar'`); the §7 tables then use
`issue='pipelined'`, which models the paper's distributed loop-buffer
control (§4.4, §4.3.6: "Different VFUs can execute different
instructions simultaneously") — VWR reads, shuffles, SRAM transactions
and VFU ops each belong to a different component, so steady-state
throughput is the *max* over per-component counts, not the sum.

Baseline architectures use documented first-order dataflow models
(GEMM fold model for systolic arrays, lane/VRF model for the vector
machine, SM-occupancy/stall model for the GPU).  The paper generated
these with the ZigZag DSE and vendor profiling, which we do not have;
our models are calibrated to the paper's order of magnitude and
reproduce the paper's *relative* claims:

  * utilization roughly comparable across Provet/ARA/TPU/Eyeriss on
    ResNet/AlexNet; GPU utilization (vs its own peak) far lower;
  * systolic arrays collapse on MobileNet depthwise layers (low reuse,
    fold waste) while Provet/ARA (1D, linear bandwidth) hold;
  * CMR: Provet >= ARA > GPU >= SAs, gap exploding on depthwise.

Deviations are logged in DESIGN.md §8; absolute numbers are printed
next to the paper's values by benchmarks/paper_tables.py.

Units: reads in mega-words (8-bit operands); latency in ms @ 200 MHz
(Table 4's normalization).  GPU utilization/latency use real device
scale (6912 cores) because the paper measures the A100 against its own
peak while normalizing latency — reproducing its seeming paradox of
"lowest utilization, yet low latency".
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.machine import ProvetConfig


# ======================================================================
# layer suite (Table 3/4 rows)
# ======================================================================

@dataclass(frozen=True)
class ConvLayer:
    name: str
    H_in: int
    W_in: int
    C_in: int
    C_out: int
    K: int
    stride: int = 1
    depthwise: bool = False

    @property
    def H_out(self):
        return (self.H_in - self.K) // self.stride + 1

    @property
    def W_out(self):
        return (self.W_in - self.K) // self.stride + 1

    @property
    def macs(self):
        per_out = self.K * self.K * (1 if self.depthwise else self.C_in)
        return self.H_out * self.W_out * self.C_out * per_out

    @property
    def in_words(self):
        return self.H_in * self.W_in * self.C_in

    @property
    def w_words(self):
        kk = self.K * self.K
        return kk * self.C_out * (1 if self.depthwise else self.C_in)

    @property
    def out_words(self):
        return self.H_out * self.W_out * self.C_out

    @property
    def reduction(self):
        """GEMM K-dim: im2col reduction length."""
        return self.K * self.K * (1 if self.depthwise else self.C_in)


# Dims chosen so MACs match the paper's MOPS column where it is
# internally consistent (= 2*MACs for RN_112/56, AN_*); where it is not
# (RN_28/14/7, MN_112/56 do not reproduce from the published network
# definitions) we keep the published network layer and report the
# discrepancy in the benchmark output.
LAYERS: List[ConvLayer] = [
    ConvLayer("RN_112x112", 224 + 6, 224 + 6, 3, 64, 7, 2),
    ConvLayer("RN_56x56", 56 + 2, 56 + 2, 64, 64, 3),
    ConvLayer("RN_28x28", 28 + 2, 28 + 2, 128, 128, 3),
    ConvLayer("RN_14x14", 14 + 2, 14 + 2, 256, 256, 3),
    ConvLayer("RN_7x7", 7 + 2, 7 + 2, 512, 512, 3),
    ConvLayer("AN_55x55", 224 + 3, 224 + 3, 3, 96, 11, 4),
    ConvLayer("AN_27x27", 27 + 4, 27 + 4, 96, 256, 5),
    ConvLayer("AN_13x13", 13 + 2, 13 + 2, 256, 384, 3),
    ConvLayer("MN_112x112", 112 + 2, 112 + 2, 32, 32, 3, 1, True),
    ConvLayer("MN_56x56", 56 + 2, 56 + 2, 128, 128, 3, 1, True),
    ConvLayer("MN_7x7", 7 + 2, 7 + 2, 1024, 1024, 3, 1, True),
]

LAYERS_BY_NAME = {l.name: l for l in LAYERS}


@dataclass
class Result:
    arch: str
    layer: str
    macs: int
    cycles: float
    utilization: float
    reads_mwords: float
    cmr: float

    @property
    def latency_ms(self):
        return self.cycles / 200e6 * 1e3       # 200 MHz


# ======================================================================
# Provet — closed-form count of the conv2d template
# ======================================================================

# production-scale Provet: 64 VFUs x 64 8-bit lanes (4096 lanes); each
# VFU's SRAM/VWR region is N=8 slices wide (the paper's 8x width ratio,
# §4.3.1) -> SRAM rows of 64*64*8 = 32768 operands.
PROVET_FULL = ProvetConfig(sram_width=32768, sram_depth=32, vfu_width=64,
                           n_vfus=64, vfu_shuffle_range=16,
                           tile_shuffle_range=8)


def template_conv_counts(cfg: ProvetConfig, layer: ConvLayer) -> Dict[str, float]:
    """Closed-form counts that mirror templates.conv2d EXACTLY
    (single-VFU, scalar issue, §6.1 accumulator-shift dataflow).
    Property-tested against the ISA interpreter's counters."""
    assert cfg.n_vfus == 1
    V, S, W = cfg.vfu_width, cfg.n_slices, cfg.sram_width
    K = layer.K
    C_in = 1 if layer.depthwise else layer.C_in
    C_out = layer.C_out
    H_in, H_out = layer.H_in, layer.H_out
    rng = cfg.vfu_shuffle_range
    assert layer.stride == 1 and layer.W_in <= V

    n_conv = C_out            # depthwise: per-channel convs, C_in=1 each
    vmv = mac = C_in * K * K
    perm = 1 + C_in * ((K - 1) * K + K * math.ceil((K - 1) / rng))
    rmv = wlb = 1

    # image RLBs per (co, k): transitions of (c*H_in + k + j)//S over the
    # (c, j) visit order, VWR dirtied by staging each output row, plus
    # the staging RLB itself; kernel RLBs from monotone tap order.
    rlb_img_total = 0
    for k in range(H_out):
        seq = [(c * H_in + k + j) // S for c in range(C_in)
               for j in range(K)]
        trans = 1 + sum(1 for a, b in zip(seq, seq[1:]) if a != b)
        rlb_img_total += trans
    rlb_img_total *= n_conv

    # kernel RLBs: simulate the load tracker over the (co, k) visit
    # order — taps of one co may straddle SRAM-row boundaries, in which
    # case every output row re-walks that co's row sequence
    taps_per_co = C_in * K * K
    rlb_ker_total = 0
    prev_row = None
    for co in range(n_conv):
        start = co * taps_per_co
        rows_seq = list(dict.fromkeys(
            (start + t) // W for t in range(taps_per_co)))
        for _k in range(H_out):
            for r in rows_seq:
                if r != prev_row:
                    rlb_ker_total += 1
                    prev_row = r

    instrs = (n_conv * H_out * (vmv + mac + perm + rmv + wlb + 1)  # +stagRLB
              + rlb_img_total + rlb_ker_total)
    sram_reads = rlb_img_total + rlb_ker_total + n_conv * H_out
    sram_writes = n_conv * H_out
    return {
        "cycles": float(instrs),
        "sram_reads": float(sram_reads),
        "sram_writes": float(sram_writes),
        "compute_instrs": float(n_conv * H_out * mac),
        "mem_instrs": float(sram_reads + sram_writes),
    }


def provet_conv_counts(cfg: ProvetConfig, layer: ConvLayer,
                       issue: str = "pipelined") -> Dict[str, float]:
    """Production mapping counts (the §7 configuration).

    Mapping decisions (§5.2/§6, plus two scheduling refinements the
    paper's control structure §4.4 enables — both recorded in DESIGN.md):
      * work item = (output-row group x strip x output channel); VFU v
        keeps output channel v mod C_out for the whole layer, so its
        kernel stays resident in its VWR-B region (loaded ~once);
      * image rows are stored channel-interleaved (HWC rows), so the
        C_in*K composite rows a wave needs are contiguous: a wave costs
        ceil(C_in*K/N) broadcast transactions (dense; the tile shuffler
        fans one region out to all VFUs) or ceil(K/N) wide transactions
        (depthwise: per-VFU-distinct channels share one wide row);
      * image-shift variant of §6.1: the *image* register is shifted
        one lane per tap (ping-pong through the VFU shuffler) instead
        of the accumulator, which breaks the mac->shift->mac dependency
        so the shuffler and VFU streams pipeline (issue='pipelined');
      * stride>1: rows are phase-split/repacked by the shuffler at load
        (hidden under the mac stream); out-dense lanes.
    """
    V, N = cfg.vfu_width, cfg.slices_per_vfu
    K, s = layer.K, layer.stride
    C_in = 1 if layer.depthwise else layer.C_in
    C_out = layer.C_out
    rng = cfg.vfu_shuffle_range

    if layer.W_in <= V and s == 1:
        pack = max(1, V // layer.W_in)
        n_strips = 1
    else:
        pack = 1
        out_per_strip = max(1, V - math.ceil((K - 1) / s))
        n_strips = math.ceil(layer.W_out / out_per_strip)

    row_groups = math.ceil(layer.H_out / pack)
    waves = math.ceil(row_groups * n_strips * C_out / cfg.n_vfus)

    mac = C_in * K * K                       # VFUX stream (VWR-A port)
    vmv = C_in * K * K                       # broadcast stream (VWR-B port)
    perm = C_in * K * K + (s - 1) * math.ceil(C_in * K / N)  # shuffler
    if layer.depthwise:
        rlb_img = math.ceil(K * pack / N)
    else:
        rlb_img = math.ceil(C_in * K * pack / N)
    taps_per_vfu = C_in * K * K
    ker_thrash = ker_rows = math.ceil(taps_per_vfu / (N * V))
    rlb_ker = 0 if ker_rows == 1 else ker_rows      # resident if it fits
    rlb = rlb_img + rlb_ker + 1              # +1 staging RMW read
    wlb = 1

    if issue == "scalar":
        cycles = waves * (vmv + mac + perm + rlb + wlb + 1)
    else:
        cycles = waves * max(mac, vmv, perm, rlb + wlb + 1)

    sram_reads = waves * rlb + math.ceil(taps_per_vfu / (N * V)) *         (0 if rlb_ker else 1) * math.ceil(C_out / cfg.n_vfus)
    sram_writes = waves * wlb
    compute_instrs = waves * mac
    return {
        "cycles": float(cycles),
        "waves": waves,
        "sram_reads": float(sram_reads),
        "sram_writes": float(sram_writes),
        "compute_instrs": float(compute_instrs),
        "mem_instrs": float(sram_reads + sram_writes),
        "pack": pack,
        "n_strips": n_strips,
    }


def provet_model(layer: ConvLayer, cfg: ProvetConfig = PROVET_FULL,
                 issue: str = "pipelined") -> Result:
    c = provet_conv_counts(cfg, layer, issue=issue)
    lanes = cfg.n_vfus * cfg.vfu_width
    util = layer.macs / (lanes * c["cycles"])
    # words actually consumed per transaction: one per-VFU region (N*V
    # operands) for broadcast reads, one full row for distinct reads
    reads_words = c["sram_reads"] * cfg.slices_per_vfu * cfg.vfu_width
    # CMR in word-normalized units (macs per word read from the global
    # SRAM) so it is comparable across architectures; the paper's
    # instruction-count CMR (eq. 4) is c[compute]/c[mem] and is what the
    # ISA machine reports — both are printed by the benchmark.
    cmr = layer.macs / max(reads_words, 1)
    r = Result("Provet", layer.name, layer.macs, c["cycles"], util,
               reads_words / 1e6, cmr)
    r.cmr_instr = c["compute_instrs"] / c["mem_instrs"]  # type: ignore
    return r


# ======================================================================
# systolic arrays (GEMM fold model)
# ======================================================================

def sa_model(layer: ConvLayer, name: str, rows: int, cols: int,
             bw_words: float, input_reuse: float = 1.0) -> Result:
    """Weight-stationary GEMM fold model with in-array psum
    accumulation (psums live in dedicated accumulators, not the global
    buffer — as in the TPU).  conv as GEMM: M = out pixels,
    Kd = C_in*K^2 (im2col), N = C_out.  Depthwise degenerates to
    per-channel GEMMs with Kd = K^2, N = 1: fold waste idles the array
    (§3.4)."""
    M = layer.H_out * layer.W_out
    if layer.depthwise:
        Kd, N, reps = layer.K ** 2, 1, layer.C_out
    else:
        Kd, N, reps = layer.reduction, layer.C_out, 1

    folds_r = math.ceil(Kd / rows)
    folds_c = math.ceil(N / cols)
    per_rep = folds_r * folds_c * (M + rows + cols)      # fill/drain
    cycles_compute = reps * per_rep

    # global-buffer reads: weights once; im2col'd inputs once per
    # column fold, divided by the dataflow's input-reuse factor
    reads = reps * (Kd * N + M * Kd * folds_c / input_reuse)
    cycles = max(cycles_compute, reads / bw_words)
    util = layer.macs / (rows * cols * cycles)
    return Result(name, layer.name, layer.macs, cycles, util, reads / 1e6,
                  layer.macs / reads)


def eyeriss_model(layer: ConvLayer) -> Result:
    # 12x14 row-stationary: conv rows stay in PEs, input rows reused
    # across the K kernel rows inside the array (input_reuse ~ K); the
    # small global buffer spills partial sums once per 8-deep
    # accumulation pass (not free like the TPU's accumulators)
    r = sa_model(layer, "Eyeriss", 12, 14, bw_words=16.0,
                 input_reuse=layer.K)
    M = layer.H_out * layer.W_out
    Kd = layer.K ** 2 if layer.depthwise else layer.reduction
    N = 1 if layer.depthwise else layer.C_out
    reps = layer.C_out if layer.depthwise else 1
    spills = max(0, math.ceil(Kd / (12 * 8)) - 1)
    extra = reps * spills * M * N
    reads = r.reads_mwords * 1e6 + extra
    r.reads_mwords = reads / 1e6
    r.cmr = layer.macs / reads
    r.cycles = max(r.cycles, reads / 16.0)
    r.utilization = layer.macs / (12 * 14 * r.cycles)
    return r


def tpu_model(layer: ConvLayer) -> Result:
    return sa_model(layer, "TPU", 64, 64, bw_words=64.0)


# ======================================================================
# vector processor (ARA-like, 1D)
# ======================================================================

def ara_model(layer: ConvLayer) -> Result:
    """64 8-bit lanes behind a conventional vector register file.

    1D organization: bandwidth scales with the lanes, so low-reuse
    layers do not starve (the property it shares with Provet).  The VRF
    (32 vregs) holds kernel taps + a few rows: inputs are re-fetched
    once per output channel *pair* (vreg double-use), weights stream
    once.  Memory instructions move one vreg (64 words) per issue —
    1/8 of Provet's wide transaction, which is exactly the VWR-ratio
    advantage the paper claims (§5.3.2)."""
    lanes = 64
    eff = 0.85                                     # strip-mine fringe
    cycles_compute = layer.macs / (lanes * eff)
    reps = 1 if layer.depthwise else max(1, layer.C_out // 8)
    reads = layer.w_words + layer.in_words * reps
    cycles = max(cycles_compute, reads / lanes)
    util = layer.macs / (lanes * cycles)
    return Result("ARA", layer.name, layer.macs, cycles, util, reads / 1e6,
                  layer.macs / reads)


# ======================================================================
# GPU (Ampere-like, batch 1)
# ======================================================================

def gpu_model(layer: ConvLayer) -> Result:
    """Batch-1 implicit-GEMM on an A100-class device (6912 cores).

    Utilization is measured against the device's own peak, after
    removing control stalls per the paper's methodology (75.6% of
    stalls are control; only memory stalls count).  Batch 1 removes
    the GPU's main reuse lever, so the memory-stall fraction is large;
    L2 catches about half of the inter-tile re-reads."""
    cores = 6912
    tile_n, tile_k = 16, 32
    M = layer.H_out * layer.W_out
    if layer.depthwise:
        Kd, N, reps = layer.K ** 2, 1, layer.C_out
        occupancy = min(1.0, (Kd * M) / (tile_n * tile_k * 8))
    else:
        Kd, N, reps = layer.reduction, layer.C_out, 1
        occupancy = min(1.0, N / tile_n) * min(1.0, Kd / tile_k)

    mem_stall_free = 0.075                        # batch-1 derate
    util = max(occupancy * mem_stall_free, 1e-4)
    cycles = layer.macs / (cores * util)
    # batch-1 cuDNN path: im2col materialization (write+read M*Kd) and
    # per-N-tile re-reads with little L2 help
    reads = reps * (2 * M * Kd + M * Kd * math.ceil(N / tile_n)
                    + Kd * N * math.ceil(M / 128))
    return Result("GPU", layer.name, layer.macs, cycles, util, reads / 1e6,
                  layer.macs / reads)


# ======================================================================
# suite driver
# ======================================================================

MODELS = {
    "Eyeriss": eyeriss_model,
    "TPU": tpu_model,
    "ARA": ara_model,
    "GPU": gpu_model,
    "Provet": provet_model,
}


def run_suite() -> Dict[str, Dict[str, Result]]:
    """{layer: {arch: Result}} for all §7 layers and architectures."""
    out: Dict[str, Dict[str, Result]] = {}
    for layer in LAYERS:
        out[layer.name] = {a: f(layer) for a, f in MODELS.items()}
    return out


def improvement_table(suite=None) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Table 3: Provet improvement ratios (utilization and CMR)."""
    suite = suite or run_suite()
    table = {}
    for lname, res in suite.items():
        p = res["Provet"]
        table[lname] = {
            "utilization": {a: p.utilization / max(r.utilization, 1e-9)
                            for a, r in res.items() if a != "Provet"},
            "cmr": {a: p.cmr / max(r.cmr, 1e-9)
                    for a, r in res.items() if a != "Provet"},
        }
    return table


# paper's published Table 3 (for side-by-side reporting in benchmarks)
PAPER_TABLE3 = {
    "RN_112x112": {"utilization": {"Eyeriss": 1.70, "TPU": 1.08, "ARA": 1.01, "GPU": 15.97},
                   "cmr": {"Eyeriss": 4.09, "TPU": 3.00, "ARA": 1.36, "GPU": 1.25}},
    "RN_56x56": {"utilization": {"Eyeriss": 1.37, "TPU": 1.03, "ARA": 1.04, "GPU": 9.71},
                 "cmr": {"Eyeriss": 3.63, "TPU": 3.00, "ARA": 1.24, "GPU": 1.21}},
    "RN_28x28": {"utilization": {"Eyeriss": 1.03, "TPU": 0.98, "ARA": 1.11, "GPU": 15.42},
                 "cmr": {"Eyeriss": 4.14, "TPU": 3.03, "ARA": 1.28, "GPU": 1.11}},
    "RN_14x14": {"utilization": {"Eyeriss": 1.19, "TPU": 1.10, "ARA": 1.20, "GPU": 19.12},
                 "cmr": {"Eyeriss": 4.00, "TPU": 3.29, "ARA": 1.31, "GPU": 1.26}},
    "RN_7x7": {"utilization": {"Eyeriss": 1.18, "TPU": 2.50, "ARA": 1.18, "GPU": 17.67},
               "cmr": {"Eyeriss": 3.60, "TPU": 3.33, "ARA": 1.53, "GPU": 1.61}},
    "AN_55x55": {"utilization": {"Eyeriss": 1.32, "TPU": 1.06, "ARA": 1.01, "GPU": 13.04},
                 "cmr": {"Eyeriss": 3.95, "TPU": 3.48, "ARA": 1.50, "GPU": 1.16}},
    "AN_27x27": {"utilization": {"Eyeriss": 1.05, "TPU": 1.31, "ARA": 1.12, "GPU": 15.65},
                 "cmr": {"Eyeriss": 4.24, "TPU": 3.07, "ARA": 1.41, "GPU": 1.20}},
    "AN_13x13": {"utilization": {"Eyeriss": 0.94, "TPU": 1.09, "ARA": 1.05, "GPU": 16.05},
                 "cmr": {"Eyeriss": 4.09, "TPU": 3.00, "ARA": 1.48, "GPU": 1.00}},
    "MN_112x112": {"utilization": {"Eyeriss": 3.18, "TPU": 2.00, "ARA": 1.08, "GPU": 12.15},
                   "cmr": {"Eyeriss": 25.00, "TPU": 15.00, "ARA": 3.13, "GPU": 2.14}},
    "MN_56x56": {"utilization": {"Eyeriss": 5.00, "TPU": 3.75, "ARA": 1.06, "GPU": 8.05},
                 "cmr": {"Eyeriss": 19.50, "TPU": 15.60, "ARA": 2.69, "GPU": 3.00}},
    "MN_7x7": {"utilization": {"Eyeriss": 9.43, "TPU": 3.67, "ARA": 1.10, "GPU": 5.04},
               "cmr": {"Eyeriss": 24.67, "TPU": 18.50, "ARA": 2.96, "GPU": 3.08}},
}

# paper's Table 4 (reads in M, latency in ms) for side-by-side reporting
PAPER_TABLE4 = {
    # layer: (MOPS, {arch: (reads, latency)})
    "RN_112x112": (236.0, {"Eyeriss": (22.434, 9.231), "TPU": (33.891, 0.320),
                           "ARA": (15.125, 5.657), "GPU": (90.287, 1.757),
                           "Provet": (6.611, 0.193)}),
    "RN_56x56": (231.2, {"Eyeriss": (22.093, 9.035), "TPU": (33.058, 0.315),
                         "ARA": (14.820, 5.516), "GPU": (88.416, 1.713),
                         "Provet": (6.454, 0.189)}),
    "RN_28x28": (115.6, {"Eyeriss": (11.025, 4.492), "TPU": (16.587, 0.156),
                         "ARA": (7.398, 2.777), "GPU": (44.302, 0.856),
                         "Provet": (3.223, 0.095)}),
    "RN_14x14": (115.6, {"Eyeriss": (11.072, 4.536), "TPU": (16.493, 0.157),
                         "ARA": (7.414, 2.785), "GPU": (44.258, 0.861),
                         "Provet": (3.222, 0.095)}),
    "RN_7x7": (115.6, {"Eyeriss": (11.067, 4.551), "TPU": (16.609, 0.157),
                       "ARA": (7.344, 2.752), "GPU": (44.230, 0.859),
                       "Provet": (3.189, 0.095)}),
    "AN_55x55": (210.8, {"Eyeriss": (20.156, 8.257), "TPU": (30.189, 0.286),
                         "ARA": (13.456, 5.029), "GPU": (80.055, 1.550),
                         "Provet": (5.834, 0.171)}),
    "AN_27x27": (895.8, {"Eyeriss": (85.803, 34.885), "TPU": (127.607, 1.223),
                         "ARA": (57.337, 21.333), "GPU": (342.714, 6.639),
                         "Provet": (24.942, 0.729)}),
    "AN_13x13": (299.0, {"Eyeriss": (28.512, 11.630), "TPU": (42.560, 0.406),
                         "ARA": (19.174, 7.107), "GPU": (114.604, 2.211),
                         "Provet": (8.363, 0.244)}),
    "MN_112x112": (0.7, {"Eyeriss": (0.131, 1.125), "TPU": (0.191, 0.435),
                         "ARA": (0.088, 0.954), "GPU": (0.512, 3.059),
                         "Provet": (0.038, 0.339)}),
    "MN_56x56": (1.8, {"Eyeriss": (0.340, 0.768), "TPU": (0.515, 0.510),
                       "ARA": (0.231, 1.071), "GPU": (1.374, 3.651),
                       "Provet": (0.101, 0.403)}),
    "MN_7x7": (0.5, {"Eyeriss": (0.090, 0.689), "TPU": (0.131, 0.218),
                     "ARA": (0.057, 0.887), "GPU": (0.343, 2.089),
                     "Provet": (0.025, 0.230)}),
}
