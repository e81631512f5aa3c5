"""OPENQASM 2.0 circuit recording (reference: ``QuEST/src/QuEST_qasm.c``).

Pure host-side string accumulation, one logger per Qureg: a copy of the
part of ``quest_tpu/qasm.py`` that the ported gates and initialisers call,
so the recorded text matches the JAX package's byte for byte (the
reference's header, gate-name table, ``c`` prefix per control, ZYZ
decompositions of unitaries and the REAL_QASM_FORMAT number format),
the phase-function records included.
"""

from __future__ import annotations

import math

import numpy as np

from . import precision
from .matrices import rotation_around_axis_pair

#: gate-name table, mirroring qasmGateLabels (QuEST_qasm.c:40-54)
GATE_QASM_LABELS = {
    "sigmaX": "x", "sigmaY": "y", "sigmaZ": "z",
    "tGate": "t", "sGate": "s", "hadamard": "h",
    "rotateX": "Rx", "rotateY": "Ry", "rotateZ": "Rz",
    "unitary": "U", "phaseShift": "Rz", "swap": "swap", "sqrtSwap": "sqrtswap",
}


# ---------------------------------------------------------------------------
# decomposition helpers (QuEST_common.c:120-153)
# ---------------------------------------------------------------------------

def zyz_angles_from_complex_pair(alpha: complex, beta: complex):
    """U(alpha, beta) = Rz(rz2) Ry(ry) Rz(rz1), as
    getZYZRotAnglesFromComplexPair (QuEST_common.c:130-139)."""
    alpha, beta = complex(alpha), complex(beta)
    alpha_mag = abs(alpha)
    ry = 2.0 * math.acos(min(alpha_mag, 1.0))
    alpha_phase = math.atan2(alpha.imag, alpha.real)
    beta_phase = math.atan2(beta.imag, beta.real)
    rz2 = -alpha_phase + beta_phase
    rz1 = -alpha_phase - beta_phase
    return rz2, ry, rz1


def complex_pair_and_phase_from_unitary(u):
    """u = exp(i globalPhase) [[alpha, -conj(beta)], [beta, conj(alpha)]], as
    getComplexPairAndPhaseFromUnitary (QuEST_common.c:142-153)."""
    u = np.asarray(u, dtype=complex)
    r0c0_phase = math.atan2(u[0, 0].imag, u[0, 0].real)
    r1c1_phase = math.atan2(u[1, 1].imag, u[1, 1].real)
    global_phase = (r0c0_phase + r1c1_phase) / 2.0
    rot = complex(math.cos(global_phase), -math.sin(global_phase))
    alpha = u[0, 0] * rot
    beta = u[1, 0] * rot
    return alpha, beta, global_phase


class QASMLogger:
    def __init__(self, num_qubits: int, dtype=None):
        self.num_qubits = num_qubits
        self.recording = False
        # REAL_QASM_FORMAT: %.8g single / %.14g double (QuEST_precision.h)
        prec = (precision.precision_for_dtype(dtype) if dtype is not None
                else precision.default_precision())
        self._fmt = "%.8g" if prec == 1 else "%.14g"
        self._lines: list[str] = []
        self._write_header()

    def _write_header(self):
        self._lines = [
            "OPENQASM 2.0;",
            f"qreg q[{self.num_qubits}];",
            f"creg c[{self.num_qubits}];",
        ]

    # -- control (startRecordingQASM etc., QuEST.h:3906-3965) ---------------

    def start(self):
        self.recording = True

    def stop(self):
        self.recording = False

    def clear(self):
        self._write_header()

    def printed(self) -> str:
        return "\n".join(self._lines) + "\n"

    def write_to_file(self, filename: str):
        with open(filename, "w") as f:
            f.write(self.printed())

    def _num(self, p) -> str:
        return self._fmt % float(p)

    def _add_gate(self, gate: str, controls, target, params=()):
        label = GATE_QASM_LABELS.get(gate, gate)
        line = "c" * len(controls) + label
        if params:
            line += "(" + ",".join(self._num(p) for p in params) + ")"
        line += " " + "".join(f"q[{c}]," for c in controls) + f"q[{int(target)}];"
        self._lines.append(line)

    # -- gate records (qasm_record*, QuEST_qasm.c:175-426) ------------------

    def record_gate(self, gate: str, target: int):
        if self.recording:
            self._add_gate(gate, (), target)

    def record_param_gate(self, gate: str, target: int, param: float):
        if self.recording:
            self._add_gate(gate, (), target, (param,))

    def record_compact_unitary(self, alpha, beta, target: int):
        if not self.recording:
            return
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", (), target, (rz2, ry, rz1))

    def record_unitary(self, u, target: int):
        if not self.recording:
            return
        alpha, beta, _ = complex_pair_and_phase_from_unitary(u)
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", (), target, (rz2, ry, rz1))

    def record_axis_rotation(self, angle, axis, target: int):
        if not self.recording:
            return
        alpha, beta = rotation_around_axis_pair(angle, axis)
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", (), target, (rz2, ry, rz1))

    def record_controlled_gate(self, gate: str, control: int, target: int):
        if self.recording:
            self._add_gate(gate, (control,), target)

    def record_controlled_param_gate(self, gate: str, control: int,
                                     target: int, param: float):
        if not self.recording:
            return
        self._add_gate(gate, (control,), target, (param,))
        # correct the global phase of controlled phase shifts
        # (qasm_recordControlledParamGate, QuEST_qasm.c:244-259)
        if gate == "phaseShift":
            self.record_comment("Restoring the discarded global phase of the "
                                "previous controlled phase gate")
            self._add_gate("rotateZ", (), target, (param / 2.0,))

    def record_controlled_compact_unitary(self, alpha, beta,
                                          control: int, target: int):
        if not self.recording:
            return
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", (control,), target, (rz2, ry, rz1))

    def record_controlled_unitary(self, u, control: int, target: int):
        """Also an Rz on the target that restores the global phase QASM's
        U(a,b,c) drops (qasm_recordControlledUnitary)."""
        if not self.recording:
            return
        self.record_multi_controlled_unitary(u, (control,), target,
                                             _kind="controlled")

    def record_controlled_axis_rotation(self, angle, axis,
                                        control: int, target: int):
        if not self.recording:
            return
        alpha, beta = rotation_around_axis_pair(angle, axis)
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", (control,), target, (rz2, ry, rz1))

    def record_multi_controlled_gate(self, gate: str, controls, target: int):
        if self.recording:
            self._add_gate(gate, tuple(controls), target)

    def record_multi_controlled_param_gate(self, gate: str, controls,
                                           target: int, param: float):
        if not self.recording:
            return
        self._add_gate(gate, tuple(controls), target, (param,))
        if gate == "phaseShift":
            self.record_comment("Restoring the discarded global phase of the "
                                "previous multicontrolled phase gate")
            self._add_gate("rotateZ", (), target, (param / 2.0,))

    def record_multi_controlled_unitary(self, u, controls, target: int,
                                        _kind: str = "multicontrolled"):
        if not self.recording:
            return
        alpha, beta, global_phase = complex_pair_and_phase_from_unitary(u)
        rz2, ry, rz1 = zyz_angles_from_complex_pair(alpha, beta)
        self._add_gate("unitary", tuple(controls), target, (rz2, ry, rz1))
        self.record_comment("Restoring the discarded global phase of the "
                            f"previous {_kind} unitary")
        self._add_gate("rotateZ", (), target, (global_phase,))

    def record_multi_state_controlled_unitary(self, u, controls, states,
                                              target: int):
        """Controls-on-0 wrapped in NOTs
        (qasm_recordMultiStateControlledUnitary, QuEST_qasm.c:358-376)."""
        if not self.recording:
            return
        self.record_comment(
            "NOTing some gates so that the subsequent unitary is controlled-on-0")
        for c, s in zip(controls, states):
            if s == 0:
                self._add_gate("sigmaX", (), c)
        self.record_multi_controlled_unitary(u, controls, target)
        self.record_comment(
            "Undoing the NOTing of the controlled-on-0 qubits of the previous unitary")
        for c, s in zip(controls, states):
            if s == 0:
                self._add_gate("sigmaX", (), c)

    def record_multi_controlled_multi_qubit_not(self, controls, targets):
        """(qasm_recordMultiControlledMultiQubitNot, QuEST_qasm.c:378-388)."""
        if not self.recording:
            return
        name = ("multiControlledMultiQubitNot" if controls
                else "multiQubitNot")
        self.record_comment(
            f"The following {len(targets)} gates resulted from a single "
            f"{name}() call")
        for t in targets:
            self._add_gate("sigmaX", tuple(controls), t)

    def record_measurement(self, target: int):
        if self.recording:
            self._lines.append(f"measure q[{target}] -> c[{target}];")

    # -- init records (QuEST_qasm.c:438-480) --------------------------------

    def record_init_zero(self):
        """INIT_ZERO_CMD: ``reset q;`` (QuEST_qasm.c:33,470-480)."""
        if self.recording:
            self._lines.append("reset q;")

    def record_init_plus(self):
        if self.recording:
            self.record_comment("Initialising state |+>")
            self.record_init_zero()
            self._lines.append("h q;")

    def record_init_classical(self, state_index: int):
        if not self.recording:
            return
        self.record_comment(f"Initialising state |{int(state_index)}>")
        self.record_init_zero()
        for q in range(self.num_qubits):
            if (int(state_index) >> q) & 1:
                self._add_gate("sigmaX", (), q)

    def record_comment(self, comment: str):
        """qasm_recordComment (QuEST_qasm.c): used for every op QASM cannot
        express -- init, decoherence, phase functions, QFT internals etc."""
        if self.recording:
            self._lines.append(f"// {comment}")

    # -- phase-function records (QuEST_qasm.c:485-868) ----------------------
    #
    # Phase functions aren't expressible in OPENQASM 2.0; the reference
    # renders them as structured comments -- the applied scalar in closed
    # form, the sub-register qubit lists, and any overrides -- and these
    # mirror that text.

    @staticmethod
    def _symbol(num_regs: int, ind: int) -> str:
        """getPhaseFuncSymbol (QuEST_qasm.c:553-566)."""
        if num_regs <= 7:
            return "xyztrvu"[ind]
        if num_regs <= 24:
            return "abcdefghjklmnpqrstuvwxyz"[ind]  # no i or o
        return f"x{ind}"

    def _term_text(self, coeff, exponent, symbol, first):
        mag = coeff if first else abs(coeff)
        if exponent > 0:
            return f"{self._num(mag)} {symbol}^{self._num(exponent)}"
        return f"{self._num(mag)} {symbol}^({self._num(exponent)})"

    def _add_regs_comment(self, qubits_flat, reg_sizes, encoding):
        """addMultiVarRegsToQASM (QuEST_qasm.c:568-596)."""
        enc = "an unsigned" if int(encoding) == 0 else "a two's complement"
        self.record_comment("  upon substates informed by qubits (under "
                            f"{enc} binary encoding)")
        off = 0
        for r, m in enumerate(reg_sizes):
            sym = f"|{self._symbol(len(reg_sizes), r)}>"
            qs = ", ".join(str(int(q)) for q in qubits_flat[off:off + m])
            self._lines.append(f"//     {sym} = {{{qs}}}")
            off += m

    def _add_overrides_comment(self, num_regs, override_inds, override_phases):
        """addMultiVarOverridesToQASM (QuEST_qasm.c:598-636)."""
        self.record_comment("  though with overrides")
        vi = 0
        for v in range(len(override_phases)):
            parts = []
            for r in range(num_regs):
                sym = self._symbol(num_regs, r)
                parts.append(f"{sym}={int(override_inds[vi])}")
                vi += 1
            p = float(override_phases[v])
            phase = (f"exp(i {self._num(p)})" if p >= 0
                     else f"exp(i ({self._num(p)}))")
            self._lines.append("//     |" + ", ".join(parts) + f"> -> {phase}")

    def record_phase_func(self, qubits, encoding, coeffs, exponents,
                          override_inds, override_phases):
        """qasm_recordPhaseFunc (QuEST_qasm.c:485-550)."""
        if not self.recording:
            return
        self.record_comment(
            "Here, applyPhaseFunc() multiplied a complex scalar of the form")
        terms = []
        for t, (c, e) in enumerate(zip(coeffs, exponents)):
            if t > 0:
                terms.append(" + " if float(coeffs[t]) > 0 else " - ")
            terms.append(self._term_text(float(c), float(e), "x", t == 0))
        self._lines.append("//     exp(i (" + "".join(terms) + "))")
        enc = "an unsigned" if int(encoding) == 0 else "a two's complement"
        self.record_comment("  upon every substate |x>, informed by qubits "
                            f"(under {enc} binary encoding)")
        self._lines.append(
            "//     {" + ", ".join(str(int(q)) for q in qubits) + "}")
        if override_phases:
            self.record_comment("  though with overrides")
            for i, p in zip(override_inds, override_phases):
                p = float(p)
                phase = (f"exp(i {self._num(p)})" if p >= 0
                         else f"exp(i ({self._num(p)}))")
                self.record_comment(f"    |{int(i)}> -> {phase}")

    def record_multi_var_phase_func(self, qubits_flat, reg_sizes, encoding,
                                    coeffs, exponents, terms_per_reg,
                                    override_inds, override_phases):
        """qasm_recordMultiVarPhaseFunc (QuEST_qasm.c:661-719)."""
        if not self.recording:
            return
        self.record_comment("Here, applyMultiVarPhaseFunc() multiplied a "
                            "complex scalar of the form")
        self.record_comment("    exp(i (")
        num_regs = len(reg_sizes)
        ti = 0
        for r in range(num_regs):
            sym = self._symbol(num_regs, r)
            line = " + " if float(coeffs[ti]) > 0 else " - "
            parts = [line]
            for t in range(terms_per_reg[r]):
                parts.append(self._term_text(
                    abs(float(coeffs[ti])), float(exponents[ti]), sym, False))
                if t < terms_per_reg[r] - 1:
                    parts.append(" + " if float(coeffs[ti + 1]) > 0 else " - ")
                ti += 1
            tail = " ))" if r == num_regs - 1 else ""
            self._lines.append("//         " + "".join(parts) + tail)
        self._add_regs_comment(qubits_flat, reg_sizes, encoding)
        if override_phases:
            self._add_overrides_comment(num_regs, override_inds,
                                        override_phases)

    def record_named_phase_func(self, qubits_flat, reg_sizes, encoding,
                                func_code, params, override_inds,
                                override_phases):
        """qasm_recordNamedPhaseFunc (QuEST_qasm.c:721-857)."""
        if not self.recording:
            return
        self.record_comment(
            "Here, applyNamedPhaseFunc() multiplied a complex scalar of form")
        f = int(func_code)
        num_regs = len(reg_sizes)
        syms = [self._symbol(num_regs, r) for r in range(num_regs)]

        def coeff_text():
            p0 = float(params[0])
            return (f"{self._num(p0)} " if p0 > 0
                    else f"({self._num(p0)}) ")

        body = "exp(i "
        if f in (0, 1, 2, 3, 4):        # NORM family
            if f in (1, 3, 4):
                body += coeff_text()
            body += {0: "sqrt(", 1: "sqrt(", 2: "1 / sqrt("}.get(f, "/ sqrt(")
            parts = []
            for r in range(num_regs):
                if f == 4:  # SCALED_INVERSE_SHIFTED_NORM
                    # the kernel applies sum (x_r - d_r)^2; the reference's
                    # <=24-register comment misprints this as (x^2 - d) --
                    # its own >24 branch and kernel use (x-d)^2, so record
                    # the form that matches the applied scalar
                    d = float(params[2 + r])
                    sign = "+" if d < 0 else "-"
                    parts.append(f"({syms[r]}{sign}{self._num(abs(d))})^2")
                else:
                    parts.append(f"{syms[r]}^2")
            body += " + ".join(parts) + "))"
        elif f in (5, 6, 7, 8):         # PRODUCT family
            if f in (6, 8):
                body += coeff_text()
            if f == 7:
                body += "1 / ("
            elif f == 8:
                body += "/ ("
            body += " ".join(syms[:-1]) + (" " if len(syms) > 1 else "")
            body += f"{syms[-1]})"
            if f in (7, 8):
                body += ")"
        elif f in (9, 10, 11, 12, 13, 14):  # DISTANCE family
            if f in (10, 12, 13, 14):
                body += coeff_text()
            body += {9: "sqrt(", 10: "sqrt(", 11: "1 / sqrt("}.get(f, "/ sqrt(")
            parts = []
            for r in range(0, num_regs, 2):
                if f == 13:  # SCALED_INVERSE_SHIFTED_DISTANCE
                    d = float(params[2 + r // 2])
                    sign = "+" if d < 0 else "-"
                    parts.append(f"({syms[r]}-{syms[r + 1]}{sign}"
                                 f"{self._num(abs(d))})^2")
                elif f == 14:  # SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE:
                    # kernel: sum_r w_r (x_r - y_r - d_r)^2 with per-pair
                    # (factor, offset) params (ops/phasefunc.py:199-201);
                    # the reference renders no formula for this code at all
                    w = float(params[2 + r])
                    d = float(params[2 + r + 1])
                    sign = "+" if d < 0 else "-"
                    parts.append(f"{self._num(w)} ({syms[r]}-{syms[r + 1]}"
                                 f"{sign}{self._num(abs(d))})^2")
                else:
                    parts.append(f"({syms[r]}-{syms[r + 1]})^2")
            body += " + ".join(parts) + "))"
        self._lines.append("//     " + body)
        self._add_regs_comment(qubits_flat, reg_sizes, encoding)
        if override_phases:
            self._add_overrides_comment(num_regs, override_inds,
                                        override_phases)

    def fmt_real(self, value: float) -> str:
        """REAL_QASM_FORMAT rendering for comment text interpolation."""
        return self._num(value)
