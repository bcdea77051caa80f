"""Provet ISA interpreter — the paper-faithful reproduction (Table 2).

Executes instruction streams against an architectural-state model
(SRAM rows, VWRs, per-VFU R1-R4) while counting cycles, SRAM/VWR
accesses, compute ops and energy.  The §6.1 CONV mapping is expressed in
this ISA (core/templates.py) and validated bit-exactly against a NumPy
convolution oracle (tests/test_isa_conv.py) — that equivalence is the
reproduction of the paper's §6 mapping claims; the counters feed the §7
metrics (utilization, compute-to-memory ratio, reads, latency).

Instruction set (Table 2):
  NOP                      no-op
  RLB  (sram row -> VWR)   wide transaction, 1 SRAM read
  WLB  (VWR -> sram row)   wide transaction, 1 SRAM write
  VMV  (VWR slice <-> local reg, optional broadcast of one operand)
  GLMV (shuffle VWR blocks through the tile shuffler, store back)
  RMV  (local reg -> VWR slice through the shuffler)
  PERM (word-level (src,dst) permute through the DPU/VFU shuffler)
  VFUX (SIMD compute: mult/add/max/mac/addacc/maxacc/clip/shift/relu/
        sigmoid/tanh); in1=R1, in2 = R4 or a VWR slice; out = R2-R4/VWR
  CALC (scalar op on local regs)  BRAN (branch)  — counted only.

Control is generated by Python loops (the paper's loop buffers are
explicitly out of its scope, §4.4); every *issued* instruction costs one
cycle, with all VFUs operating in lockstep on `vfu='all'` instructions
(different VFUs may also issue distinct instructions in the same cycle —
modeled by `parallel=True` marking issue slots that overlap).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.machine import (ProvetConfig, shuffle_energy_fj,
                                      sram_word_energy_fj,
                                      vwr_access_energy_fj)

Reg = str  # 'R1'..'R4'


# ---------------------------------------------------------------- instrs

@dataclass(frozen=True)
class NOP:
    pass


@dataclass(frozen=True)
class RLB:
    """SRAM[row] -> VWR[vwr]. Optional tile-shuffle by `block_shift`."""
    vwr: int
    row: int
    block_shift: int = 0          # coarse shuffler, units of vfu_width


@dataclass(frozen=True)
class WLB:
    """VWR[vwr] -> SRAM[row]."""
    vwr: int
    row: int


@dataclass(frozen=True)
class VMV:
    """VWR slice -> local register (per VFU, pitch-aligned slice).

    slice_idx selects which vfu-width slice of the VWR each VFU reads:
    VFU j reads VWR[(j*n_slices_per_vfu + slice_idx)*vfu_width : ...].
    broadcast: if not None, broadcast operand `broadcast` of the slice to
    all lanes (the CONV weight-pixel broadcast of §6.1).
    """
    vwr: int
    slice_idx: int
    dst: Reg
    broadcast: Optional[int] = None


@dataclass(frozen=True)
class GLMV:
    """Tile shuffler: VWR <- VWR shifted by `block_shift` blocks."""
    vwr: int
    block_shift: int


@dataclass(frozen=True)
class RMV:
    """Local reg -> VWR slice (through shuffler, optional lane shift)."""
    vwr: int
    slice_idx: int
    src: Reg
    lane_shift: int = 0


@dataclass(frozen=True)
class PERM:
    """VFU shuffler: lane permutation of a local register.

    Either explicit (src,dst) pairs or a uniform `shift` (±k lanes);
    range must respect cfg.vfu_shuffle_range (multi-step otherwise:
    the assembler in templates.py splits long moves)."""
    src: Reg
    dst: Reg
    shift: int = 0
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    fill: float = 0.0


@dataclass(frozen=True)
class VFUX:
    """SIMD compute. in1 is a register; in2 a register or VWR slice."""
    mode: str                     # mult|add|max|mac|addacc|maxacc|clip|
    in1: Reg                      # shift|relu|sigmoid|tanh|copy
    in2: Optional[Union[Reg, Tuple[int, int]]] = None  # reg or (vwr, slice)
    out: Reg = "R2"
    acc: Optional[Reg] = None     # accumulator register for *acc modes


@dataclass(frozen=True)
class CALC:
    op: str = "inc"


@dataclass(frozen=True)
class BRAN:
    taken: bool = True


Instr = Union[NOP, RLB, WLB, VMV, GLMV, RMV, PERM, VFUX, CALC, BRAN]


# ---------------------------------------------------------------- machine

class Counters:
    __slots__ = ("cycles", "sram_reads", "sram_writes", "vwr_reads",
                 "vwr_writes", "compute_instrs", "mem_instrs", "macs",
                 "alu_ops", "shuffles", "energy_fj", "instr_mix")

    def __init__(self):
        self.cycles = 0
        self.sram_reads = 0          # wide words
        self.sram_writes = 0
        self.vwr_reads = 0           # narrow (vfu-width) accesses
        self.vwr_writes = 0
        self.compute_instrs = 0
        self.mem_instrs = 0          # SRAM transactions (paper's N_memory)
        self.macs = 0
        self.alu_ops = 0
        self.shuffles = 0
        self.energy_fj = 0.0
        self.instr_mix: Dict[str, int] = {}

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.__slots__}


class ProvetMachine:
    """Architectural-state interpreter with access/cycle accounting."""

    def __init__(self, cfg: ProvetConfig, dtype=np.float32):
        self.cfg = cfg
        self.dtype = dtype
        W = cfg.sram_width
        self.sram = np.zeros((cfg.sram_depth, W), dtype)
        self.vwr = np.zeros((cfg.n_vwr, W), dtype)
        # regs[r][v] = lane values of register r of VFU v
        self.regs = {
            f"R{i+1}": np.zeros((cfg.n_vfus, cfg.vfu_width), dtype)
            for i in range(cfg.n_local_regs)
        }
        self.c = Counters()

    # -------------- helpers --------------
    def _slice(self, vfu: int, slice_idx: int) -> slice:
        per_vfu = self.cfg.sram_width // self.cfg.n_vfus
        base = vfu * per_vfu + slice_idx * self.cfg.vfu_width
        assert base + self.cfg.vfu_width <= (vfu + 1) * per_vfu, (
            "slice outside this VFU's pitch-aligned VWR region")
        return slice(base, base + self.cfg.vfu_width)

    def _count(self, instr: Instr):
        name = type(instr).__name__
        self.c.instr_mix[name] = self.c.instr_mix.get(name, 0) + 1
        self.c.cycles += 1

    # -------------- execution --------------
    def run(self, program: Sequence[Instr]):
        for ins in program:
            self.step(ins)
        return self.c

    def step(self, ins: Instr):
        cfg = self.cfg
        self._count(ins)
        wbits = cfg.sram_width_bits
        nbits = cfg.vfu_width_bits

        if isinstance(ins, NOP) or isinstance(ins, CALC) \
                or isinstance(ins, BRAN):
            return

        if isinstance(ins, RLB):
            row = self.sram[ins.row]
            if ins.block_shift:
                assert abs(ins.block_shift) <= cfg.tile_shuffle_range
                row = np.roll(row, ins.block_shift * cfg.vfu_width)
                self.c.shuffles += 1
                self.c.energy_fj += shuffle_energy_fj(wbits, ins.block_shift)
            self.vwr[ins.vwr] = row
            self.c.sram_reads += 1
            self.c.mem_instrs += 1
            self.c.energy_fj += sram_word_energy_fj(wbits, cfg.sram_depth)
            self.c.energy_fj += vwr_access_energy_fj(wbits)
            return

        if isinstance(ins, WLB):
            self.sram[ins.row] = self.vwr[ins.vwr]
            self.c.sram_writes += 1
            self.c.mem_instrs += 1
            self.c.energy_fj += sram_word_energy_fj(wbits, cfg.sram_depth)
            self.c.energy_fj += vwr_access_energy_fj(wbits)
            return

        if isinstance(ins, VMV):
            for v in range(cfg.n_vfus):
                sl = self.vwr[ins.vwr][self._slice(v, ins.slice_idx)]
                if ins.broadcast is not None:
                    sl = np.full(cfg.vfu_width, sl[ins.broadcast],
                                 self.dtype)
                self.regs[ins.dst][v] = sl
            self.c.vwr_reads += cfg.n_vfus
            self.c.energy_fj += cfg.n_vfus * vwr_access_energy_fj(nbits)
            return

        if isinstance(ins, GLMV):
            assert abs(ins.block_shift) <= cfg.tile_shuffle_range
            self.vwr[ins.vwr] = np.roll(
                self.vwr[ins.vwr], ins.block_shift * cfg.vfu_width)
            self.c.shuffles += 1
            self.c.vwr_reads += 1
            self.c.vwr_writes += 1
            self.c.energy_fj += shuffle_energy_fj(wbits, ins.block_shift) \
                + 2 * vwr_access_energy_fj(wbits)
            return

        if isinstance(ins, RMV):
            for v in range(cfg.n_vfus):
                val = self.regs[ins.src][v]
                if ins.lane_shift:
                    assert abs(ins.lane_shift) <= cfg.vfu_shuffle_range
                    val = np.roll(val, ins.lane_shift)
                self.vwr[ins.vwr][self._slice(v, ins.slice_idx)] = val
            self.c.vwr_writes += cfg.n_vfus
            self.c.energy_fj += cfg.n_vfus * vwr_access_energy_fj(nbits)
            if ins.lane_shift:
                self.c.shuffles += 1
                self.c.energy_fj += shuffle_energy_fj(nbits, ins.lane_shift)
            return

        if isinstance(ins, PERM):
            for v in range(cfg.n_vfus):
                src = self.regs[ins.src][v]
                if ins.pairs is not None:
                    out = np.full(cfg.vfu_width, ins.fill, self.dtype)
                    for s, d in ins.pairs:
                        assert abs(d - s) <= cfg.vfu_shuffle_range
                        out[d] = src[s]
                else:
                    assert abs(ins.shift) <= cfg.vfu_shuffle_range
                    out = np.full(cfg.vfu_width, ins.fill, self.dtype)
                    if ins.shift >= 0:
                        out[ins.shift:] = src[:cfg.vfu_width - ins.shift] \
                            if ins.shift else src
                    else:
                        out[:ins.shift] = src[-ins.shift:]
                self.regs[ins.dst][v] = out
            self.c.shuffles += 1
            dist = ins.shift if ins.pairs is None else max(
                (abs(d - s) for s, d in ins.pairs), default=0)
            self.c.energy_fj += cfg.n_vfus * shuffle_energy_fj(nbits, dist)
            return

        if isinstance(ins, VFUX):
            self.c.compute_instrs += 1
            a = self.regs[ins.in1]
            if isinstance(ins.in2, tuple):
                vwr_id, slice_idx = ins.in2
                b = np.stack([
                    self.vwr[vwr_id][self._slice(v, slice_idx)]
                    for v in range(cfg.n_vfus)])
                self.c.vwr_reads += cfg.n_vfus
                self.c.energy_fj += cfg.n_vfus * vwr_access_energy_fj(nbits)
            elif ins.in2 is not None:
                b = self.regs[ins.in2]
            else:
                b = None

            lanes = cfg.n_vfus * cfg.vfu_width
            m = ins.mode
            if m == "mult":
                out = a * b
                self.c.alu_ops += lanes
            elif m == "add":
                out = a + b
                self.c.alu_ops += lanes
            elif m == "max":
                out = np.maximum(a, b)
                self.c.alu_ops += lanes
            elif m == "mac":
                acc = self.regs[ins.acc or ins.out]
                out = acc + a * b
                self.c.macs += lanes
            elif m == "addacc":
                acc = self.regs[ins.acc or ins.out]
                out = acc + a
                self.c.alu_ops += lanes
            elif m == "maxacc":
                acc = self.regs[ins.acc or ins.out]
                out = np.maximum(acc, a)
                self.c.alu_ops += lanes
            elif m == "clip":
                out = np.clip(a, 0.0, 1.0)
                self.c.alu_ops += lanes
            elif m == "shift":
                out = a * (2.0 ** (b if b is not None else 1))
                self.c.alu_ops += lanes
            elif m == "relu":
                out = np.maximum(a, 0.0)
                self.c.alu_ops += lanes
            elif m == "sigmoid":
                out = 1.0 / (1.0 + np.exp(-a.astype(np.float64)))
                self.c.alu_ops += lanes
            elif m == "tanh":
                out = np.tanh(a.astype(np.float64))
                self.c.alu_ops += lanes
            elif m == "copy":
                out = a
            else:
                raise ValueError(f"VFUX mode {m}")
            self.regs[ins.out] = out.astype(self.dtype)
            return

        raise TypeError(ins)

    # -------------- derived §7 metrics --------------
    def utilization(self, total_macs: int) -> float:
        """Eq. (3): U = L_min / L_real."""
        lanes = self.cfg.n_vfus * self.cfg.vfu_width
        l_min = total_macs / lanes
        return l_min / max(self.c.cycles, 1)

    def cmr(self) -> float:
        """Eq. (4): compute instrs / memory (SRAM) instrs."""
        return self.c.compute_instrs / max(self.c.mem_instrs, 1)
