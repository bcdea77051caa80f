"""Provet machine description + SRAM/VWR energy model (paper §4.1, §4.3).

``ProvetConfig`` pins the architectural parameters of Fig. 4:
ultra-wide shallow SRAM, N very-wide registers (VWRs) with asymmetric
ports, a coarse tile shuffler (SRAM<->VWR), per-VFU fine shufflers, and
R1-R4 local registers per VFU.

The energy model implements eq. (1)-(2):

    E_word  = W * D * BL + W * WL          (energize W bitlines, 1 wordline)
    E_bit   = D * BL + WL                  (width-normalized)

so for fixed capacity C = W*D the per-bit energy D*BL + WL = (C/W)*BL + WL
falls monotonically with width — the ultra-wide-and-shallow thesis
(Fig. 2b).  Constants are CACTI-calibrated orders of magnitude (28 nm);
absolute joules are not the claim, the W/D scaling law is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class ProvetConfig:
    """All widths in operands (one operand = ``operand_bits`` wide)."""
    sram_width: int = 64          # operands per SRAM row (ultra-wide)
    sram_depth: int = 32          # rows (shallow: 1-32 per §4.3.1)
    vfu_width: int = 16           # operands per VFU (SIMD lanes)
    n_vfus: int = 1
    n_vwr: int = 2                # §4.3.4: usually 2 for concurrent R/W
    operand_bits: int = 8
    tile_shuffle_range: int = 8   # blocks (block = vfu_width operands)
    vfu_shuffle_range: int = 16   # operands (<= vfu_width per §4.3.7)
    n_local_regs: int = 4         # R1..R4

    def __post_init__(self):
        assert self.sram_width % self.vfu_width == 0
        assert self.vfu_shuffle_range <= self.vfu_width

    @property
    def width_ratio(self) -> int:
        """N = per-VFU SRAM region / VFU width — the asymmetric-port
        ratio.  One wide VWR fill is consumed by N narrow reads, the
        paper's architectural >=N x SRAM-access reduction (§4.1)."""
        return self.sram_width // (self.n_vfus * self.vfu_width)

    @property
    def n_slices(self) -> int:
        """Total vfu-width slices in one SRAM row."""
        return self.sram_width // self.vfu_width

    @property
    def slices_per_vfu(self) -> int:
        return self.sram_width // (self.n_vfus * self.vfu_width)

    @property
    def total_lanes(self) -> int:
        return self.n_vfus * self.vfu_width

    @property
    def sram_width_bits(self) -> int:
        return self.sram_width * self.operand_bits

    @property
    def vfu_width_bits(self) -> int:
        return self.vfu_width * self.operand_bits


# paper's running example (§6.1): 16-lane VFU, 64-operand SRAM, 1 VFU
PAPER_EXAMPLE = ProvetConfig(sram_width=64, sram_depth=32, vfu_width=16,
                             n_vfus=1, n_vwr=2)

# §4.3 "real" scale: 4096-bit SRAM rows, 512-bit VFU, 8x ratio
PAPER_FULL = ProvetConfig(sram_width=512, sram_depth=32, vfu_width=64,
                          n_vfus=8, n_vwr=2)


# ======================================================================
# SRAM energy model (eq. 1-2, Fig. 2a/2b)
# ======================================================================

# CACTI-flavoured 28nm constants (fJ): energy per unit cell-pitch of
# bitline/wordline, plus fixed per-access periphery.
BL_FJ_PER_CELL = 1.1      # bitline energy per row traversed, per bit
WL_FJ_PER_CELL = 0.18     # wordline energy per column traversed, per bit
PERIPH_FJ_PER_BIT = 0.35  # sense amp / drivers, per accessed bit
VWR_FJ_PER_BIT = 0.08     # flip-flop read (no decode, no multiplexing)
SHUFFLE_FJ_PER_BIT_STEP = 0.02   # wire energy ~ shuffle distance (§5.2)
MAC_FJ_8B = 25.0          # 8-bit MAC energy (for context ratios)


def sram_word_energy_fj(width_bits: int, depth: int) -> float:
    """Eq. (1): energy to access one full word of `width_bits`."""
    return (width_bits * depth * BL_FJ_PER_CELL
            + width_bits * WL_FJ_PER_CELL
            + width_bits * PERIPH_FJ_PER_BIT)


def sram_bit_energy_fj(width_bits: int, depth: int) -> float:
    """Eq. (2): width-normalized per-bit access energy."""
    return depth * BL_FJ_PER_CELL + WL_FJ_PER_CELL + PERIPH_FJ_PER_BIT


def aspect_ratio_sweep(capacity_bits: int, widths=None) -> Dict[int, Dict]:
    """Fig. 2b: per-bit energy + bandwidth across aspect ratios at fixed
    capacity.  Returns {width_bits: {e_per_bit_fj, depth, bw_bits_per_cyc}}."""
    if widths is None:
        widths = [128, 256, 512, 1024, 2048, 4096, 8192]
    out = {}
    for w in widths:
        d = max(1, capacity_bits // w)
        out[w] = {
            "depth": d,
            "e_per_bit_fj": sram_bit_energy_fj(w, d),
            "bw_bits_per_cycle": w,
        }
    return out


def vwr_access_energy_fj(bits: int) -> float:
    """Single-row register file: no address decode, no output mux."""
    return bits * VWR_FJ_PER_BIT


def shuffle_energy_fj(bits: int, distance_steps: int) -> float:
    """§5.2: wire length (energy) scales with shuffle distance, NOT with
    total width."""
    return bits * SHUFFLE_FJ_PER_BIT_STEP * max(1, abs(distance_steps))


# ======================================================================
# shuffler vs crossbar cost model (Table 1)
# ======================================================================

# A generic W-endpoint crossbar needs ~W^2 crosspoints; the Provet
# shuffler needs W * (2*range + 1) mux inputs.  Gate/area/wire constants
# calibrated so Table 1 reproduces at the inferred paper configuration
# of 128 endpoints with reach ~11 (the paper does not state the dims;
# these are the unique (n, r) solving its gate counts):
#   shuffler 128*(2*11+1)*5.25 = 15.5k gates (paper 16k)
#   crossbar 128^2*5.25        = 86k gates   (paper 86k)
PAPER_TABLE1_ENDPOINTS = 128
PAPER_TABLE1_REACH = 11
GATES_PER_MUX_INPUT = 5.25
MM2_PER_GATE = 8.1e-6
WIRE_MM_PER_ENDPOINT_STEP = 0.00305
CROSSBAR_SPAN_FRAC = 0.66


def shuffler_cost(n_endpoints: int, reach: int) -> Dict[str, float]:
    mux_inputs = n_endpoints * (2 * reach + 1)
    gates = mux_inputs * GATES_PER_MUX_INPUT
    return {
        "gates": gates,
        "area_mm2": gates * MM2_PER_GATE,
        "wire_mm": n_endpoints * reach * WIRE_MM_PER_ENDPOINT_STEP,
    }


def crossbar_cost(n_endpoints: int) -> Dict[str, float]:
    mux_inputs = n_endpoints * n_endpoints
    gates = mux_inputs * GATES_PER_MUX_INPUT
    return {
        "gates": gates,
        "area_mm2": gates * MM2_PER_GATE,
        # average routed span ~ 0.66*W per endpoint (post-layout
        # detours; calibrated to Table 1's 33.1 mm)
        "wire_mm": n_endpoints * (CROSSBAR_SPAN_FRAC * n_endpoints)
        * WIRE_MM_PER_ENDPOINT_STEP,
    }
