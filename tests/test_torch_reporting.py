"""The port's reporting rows and QASM recording API against quest_tpu,
byte for byte: state dumps to the screen and to ``state_rank_0.csv``,
register parameters, PauliHamil listings, the recorded QASM printed and
written, and the environment report (all but its backend line, which names
each package's own runtime)."""

import jax
import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq

N = 4


def _envs(d):
    tenv = (tq.createQuESTEnv(device="cpu") if d == 1
            else tq.createQuESTEnv(devices=["cpu"] * d))
    return jq.createQuESTEnv(jax.devices()[:d]), tenv


def _pair(d, prec, density=False, seed=0):
    jenv, tenv = _envs(d)
    make = "createDensityQureg" if density else "createQureg"
    jqr, tqr = getattr(jq, make)(N, jenv, prec), getattr(tq, make)(N, tenv, prec)
    rng = np.random.RandomState(seed)
    num = jqr.num_amps_total
    re, im = rng.randn(num), rng.randn(num)
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.initStateFromAmps(q, re, im)
    return jqr, tqr


def _both(capsys, jcall, tcall):
    """What each package's call prints, in turn."""
    jcall()
    jout = capsys.readouterr().out
    tcall()
    return jout, capsys.readouterr().out


@pytest.mark.parametrize("d,prec,density", [(1, 2, False), (1, 1, False), (4, 2, False),
                                            (1, 2, True)])
def test_report_state_matches_reference(tmp_path, monkeypatch, capsys, d, prec, density):
    jqr, tqr = _pair(d, prec, density, seed=d + prec)
    files = {}
    for name, mod, q in (("j", jq, jqr), ("t", tq, tqr)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        mod.reportState(q)
        files[name] = (tmp_path / name / "state_rank_0.csv").read_bytes()
    assert files["t"] == files["j"]
    assert files["t"].startswith(b"real, imag\n")
    assert files["t"].count(b"\n") == tqr.num_amps_total + 1
    jout, tout = _both(capsys, lambda: jq.reportStateToScreen(jqr, None, 0),
                       lambda: tq.reportStateToScreen(tqr, None, 0))
    assert tout == jout and tout.startswith("Reporting state from rank 0 of 1\n")
    jout, tout = _both(capsys, lambda: jq.reportQuregParams(jqr),
                       lambda: tq.reportQuregParams(tqr))
    assert tout == jout
    assert f"Number of amps per device is {tqr.num_amps_total // d}." in tout


def test_report_pauli_hamil_matches_reference(capsys):
    rng = np.random.RandomState(1)
    codes, coeffs = rng.randint(0, 4, size=(5, N)), rng.randn(5)
    coeffs[2] = 1e-7
    th, jh = tq.createPauliHamil(N, 5), jq.createPauliHamil(N, 5)
    tq.initPauliHamil(th, coeffs, codes)
    jq.initPauliHamil(jh, coeffs, codes)
    jout, tout = _both(capsys, lambda: jq.reportPauliHamil(jh), lambda: tq.reportPauliHamil(th))
    assert tout == jout and tout.count("\n") == 5


@pytest.mark.parametrize("prec", [1, 2])
def test_recorded_qasm_matches_reference(tmp_path, capsys, prec):
    jqr, tqr = _pair(1, prec)
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.hadamard(q, 0)  # not recorded
        mod.startRecordingQASM(q)
        mod.hadamard(q, 1)
        mod.rotateZ(q, 2, 0.123456789)
        mod.controlledNot(q, 1, 3)
        mod.stopRecordingQASM(q)
        mod.pauliX(q, 0)  # not recorded
        mod.startRecordingQASM(q)
        mod.tGate(q, 3)
    jout, tout = _both(capsys, lambda: jq.printRecordedQASM(jqr),
                       lambda: tq.printRecordedQASM(tqr))
    assert tout == jout and tout.count("\n") == 7
    for name, mod, q in (("j.qasm", jq, jqr), ("t.qasm", tq, tqr)):
        mod.writeRecordedQASMToFile(q, str(tmp_path / name))
    assert (tmp_path / "t.qasm").read_bytes() == (tmp_path / "j.qasm").read_bytes()
    assert (tmp_path / "t.qasm").read_text() == tout
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.clearRecordedQASM(q)
        mod.sGate(q, 2)  # still recording after a clear
    jout, tout = _both(capsys, lambda: jq.printRecordedQASM(jqr),
                       lambda: tq.printRecordedQASM(tqr))
    assert tout == jout == f"OPENQASM 2.0;\nqreg q[{N}];\ncreg c[{N}];\ns q[2];\n"
    bad = str(tmp_path / "no-such-dir" / "out.qasm")
    with pytest.raises(jq.QuESTError) as jerr:
        jq.writeRecordedQASMToFile(jqr, bad)
    with pytest.raises(tq.QuESTError) as terr:
        tq.writeRecordedQASMToFile(tqr, bad)
    assert terr.value.message == jerr.value.message == f"Could not open file ({bad})."
    assert terr.value.func == jerr.value.func == "writeRecordedQASMToFile"


@pytest.mark.parametrize("d", [1, 4])
def test_report_env_matches_reference_but_the_backend_line(capsys, d):
    jenv, tenv = _envs(d)
    jout, tout = _both(capsys, lambda: jq.reportQuESTEnv(jenv), lambda: tq.reportQuESTEnv(tenv))
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(tl) == len(jl) == 5
    assert [x for i, x in enumerate(tl) if i != 1] == [x for i, x in enumerate(jl) if i != 1]
    assert tl[1].startswith("Backend: PyTorch ") and tl[1].endswith("devices cpu")
    assert tl[2] == f"Number of devices: {d}"
