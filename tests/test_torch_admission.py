"""The port's admission control (quest_tpu_torch/engine/admission.py)
against quest_tpu's, under one fake clock: the same scripted takes and
admissions give the same verdicts, token counts, typed rejections and
counters in both packages."""

import numpy as np
import pytest

from quest_tpu import telemetry as jtel
from quest_tpu.engine import AdmissionController as JAdmission
from quest_tpu.engine import TokenBucket as JBucket
from quest_tpu.resilience import QuESTBackpressureError as JBackpressure
from quest_tpu_torch import telemetry as ttel
from quest_tpu_torch.engine import PRIORITIES, AdmissionController, TokenBucket
from quest_tpu_torch.resilience import QuESTBackpressureError


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_priorities_match():
    from quest_tpu.engine import PRIORITIES as JPRIORITIES
    assert PRIORITIES == JPRIORITIES == ("high", "normal")


def test_token_bucket_reserve_non_starvation():
    clock = _Clock()
    b = TokenBucket(4, clock=clock)  # burst 4, reserve 1
    assert [b.take(priority="normal") for _ in range(4)] == [True, True, True, False]
    assert b.take(priority="high")
    assert not b.take(priority="high")
    clock.t += 0.5
    assert b.take(priority="normal")
    with pytest.raises(ValueError):
        b.take(priority="urgent")


@pytest.mark.parametrize("rate,burst,reserve", [(4, None, 0.25), (2.5, 6, 0.5),
                                                (10, 3, 0.0), (1, 1, 0.9)])
def test_token_bucket_script_matches_jax(rate, burst, reserve):
    """A seeded script of takes (n, priority) and clock steps: the same
    verdicts and token counts from both buckets."""
    rng = np.random.RandomState(int(rate * 10) + int(reserve * 10))
    clock = _Clock()
    mine = TokenBucket(rate, burst, reserve_frac=reserve, clock=clock)
    theirs = JBucket(rate, burst, reserve_frac=reserve, clock=clock)
    assert (mine.rate, mine.burst, mine.reserve) == (theirs.rate, theirs.burst,
                                                     theirs.reserve)
    for _ in range(60):
        if rng.rand() < 0.3:
            clock.t += float(rng.choice([0.0, 0.05, 0.3, 1.0]))
        n = int(rng.randint(1, 3))
        prio = PRIORITIES[rng.randint(2)]
        assert mine.take(n, priority=prio) == theirs.take(n, priority=prio)
        assert mine.tokens() == theirs.tokens()


@pytest.mark.parametrize("bad", [dict(rate=0), dict(rate=1, reserve_frac=1.0),
                                 dict(rate=1, burst=0.5)])
def test_token_bucket_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JBucket(**bad)
    with pytest.raises(ValueError):
        TokenBucket(**bad)


def test_admission_script_matches_jax_with_counters():
    """Tenants with a default quota, one with its own and one unlimited: the
    same admissions, the same typed quota rejections (reason "quota") and
    the same admission and backpressure counters."""
    clock = _Clock()
    kw = dict(quotas={"big": 8, "free": 0}, clock=clock)
    mine, theirs = AdmissionController(2, **kw), JAdmission(2, **kw)
    ttel.reset()
    jtel.reset()
    rng = np.random.RandomState(7)
    rejected = 0
    for _ in range(80):
        if rng.rand() < 0.2:
            clock.t += float(rng.choice([0.1, 0.5, 2.0]))
        tenant = ("acme", "big", "free", "other")[rng.randint(4)]
        prio = PRIORITIES[rng.randint(2)]
        n = int(rng.randint(1, 3))
        verdicts = []
        for adm, exc in ((mine, QuESTBackpressureError), (theirs, JBackpressure)):
            try:
                adm.admit(tenant, prio, n)
                verdicts.append(None)
            except exc as e:
                verdicts.append(e.reason)
        assert verdicts[0] == verdicts[1]
        rejected += verdicts[0] is not None
        adm_b = mine.bucket(tenant)
        assert (adm_b is None) == (theirs.bucket(tenant) is None)
        if adm_b is not None:
            assert adm_b.tokens() == theirs.bucket(tenant).tokens()
    assert rejected > 0
    mine.note_queued("acme", "high", 2)
    theirs.note_queued("acme", "high", 2)
    names = ("admission_admitted_total", "admission_rejected_total",
             "admission_queued_total")
    for tenant in ("acme", "big", "free", "other"):
        for prio in PRIORITIES:
            for name in names:
                assert ttel.counter_value(name, tenant=tenant, priority=prio) == \
                    jtel.counter_value(name, tenant=tenant, priority=prio)
    assert ttel.counter_value("engine_backpressure_total", reason="quota") == \
        jtel.counter_value("engine_backpressure_total", reason="quota") == rejected
    assert mine.bucket("free") is None


def test_admission_default_qps_from_env(monkeypatch):
    monkeypatch.setenv("QUEST_TENANT_QPS", "3")
    assert AdmissionController().default_qps == 3
    monkeypatch.setenv("QUEST_TENANT_QPS", "many")
    with pytest.warns(RuntimeWarning, match="QT307"):
        assert AdmissionController().default_qps == 0
    with pytest.raises(ValueError):
        AdmissionController(-1)
    with pytest.raises(ValueError):
        AdmissionController(1).admit("t", "urgent")
