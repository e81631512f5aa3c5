"""Reporting / debug output (reference: reportState and friends,
QuEST.h:1538-1579, QuEST_common.c:219-242) and the QASM recording API
(QuEST.h:3906-3965): a copy of ``quest_tpu/reporting.py``, whose output it
matches byte for byte. A sharded register's shards are gathered here."""

from __future__ import annotations

from . import validation
from .registers import Qureg, get_np

__all__ = [
    "reportState", "reportStateToScreen", "reportQuregParams", "reportPauliHamil",
    "startRecordingQASM", "stopRecordingQASM", "clearRecordedQASM",
    "printRecordedQASM", "writeRecordedQASMToFile",
]


def reportState(qureg: Qureg) -> None:
    """Dump amplitudes to ``state_rank_0.csv`` (reportState writes one file
    per rank in the reference, QuEST_common.c:219-231; one controlling
    process writes one)."""
    amps = get_np(qureg)
    with open("state_rank_0.csv", "w") as f:
        f.write("real, imag\n")
        for a in amps:
            f.write(f"{a.real:.12f}, {a.imag:.12f}\n")


def reportStateToScreen(qureg: Qureg, env=None, report_rank: int = 0) -> None:
    """Print every amplitude to stdout, rank-prefixed (QuEST.h:317)."""
    amps = get_np(qureg)
    print("Reporting state from rank 0 of 1")
    for a in amps:
        print(f"{a.real:.14f}, {a.imag:.14f}")


def reportQuregParams(qureg: Qureg) -> None:
    """(reportQuregParams, QuEST_common.c:233-242); amps per device over the
    env's devices."""
    print("QUBITS:")
    print(f"Number of qubits is {qureg.num_qubits_represented}.")
    print(f"Number of amps is {qureg.num_amps_total}.")
    print(f"Number of amps per device is "
          f"{qureg.num_amps_total // max(1, qureg.env.num_ranks)}.")


def reportPauliHamil(hamil) -> None:
    """Print coeff + codes lines, matching the input file format
    (reportPauliHamil)."""
    for t in range(hamil.num_sum_terms):
        codes = " ".join(str(int(c)) for c in hamil.pauli_codes[t])
        print(f"{hamil.term_coeffs[t]:g}\t{codes}")


def startRecordingQASM(qureg: Qureg) -> None:
    """Begin recording subsequent gates as QASM (QuEST.h:319)."""
    qureg.qasm_log.start()


def stopRecordingQASM(qureg: Qureg) -> None:
    """Pause QASM recording; the buffer is kept (QuEST.h:320)."""
    qureg.qasm_log.stop()


def clearRecordedQASM(qureg: Qureg) -> None:
    """Discard the QASM recorded so far (QuEST.h:321)."""
    qureg.qasm_log.clear()


def printRecordedQASM(qureg: Qureg) -> None:
    """Print the recorded QASM to stdout (QuEST.h:322)."""
    print(qureg.qasm_log.printed(), end="")


def writeRecordedQASMToFile(qureg: Qureg, filename: str) -> None:
    """Flush the recorded QASM to ``filename``; an unopenable path raises
    through the validation layer (validateFileOpened, QuEST_qasm.c:855)."""
    try:
        qureg.qasm_log.write_to_file(filename)
    except OSError:
        validation.validate_file_opened(False, filename,
                                        "writeRecordedQASMToFile")
