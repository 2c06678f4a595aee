"""The port's spans and counters (``utils/trace.py``): they record only
under a profiler, nest, carry a step id, stay bounded, take a thread
started before the profiler only inside the loop thread's interval, and
change nothing a training step computes; the assembly's stage times come
from them with no synchronise per stage.

CPU tests; the last one, marked ``cuda``, holds the device times of a
step against its three phases on the card (``python -m pytest
--noconftest -m cuda tests/test_torch_trace.py``).  No JAX here.
"""

import copy
import sys
import threading
import time

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.assembly import VoteInstancesParams, blockwise
from patchperpix_tpu_torch.assembly import to_instance_seg
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.train import trainer as T
from patchperpix_tpu_torch.utils import trace

STAGES = {"consensus", "rank", "cover", "thin_cover", "pairs", "graph",
          "mws_paint"}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _close_session():
    """End whatever session an earlier test left open."""
    with _profile():
        with trace.span("test.open"):
            pass
    trace.summary()


def test_nothing_recorded_without_a_profiler():
    _close_session()
    before = trace.summary()
    with trace.span("test.off", step=3):
        trace.count("test.off_count")
    with trace.Stages("test", None) as st:
        st.next("a")
    after = trace.summary()
    assert after == before
    assert "test.off" not in after["spans"]
    assert "test.off_count" not in after["counts"]
    assert all(r["name"] != "test.off" for r in trace.records())


def test_nested_spans_under_a_profiler_match_a_hand_timed_sequence():
    hand = []
    with _profile() as prof:
        for i in range(1, 4):
            a = time.perf_counter()
            with trace.span("test.outer", step=i):
                with trace.span("test.inner"):
                    time.sleep(0.02)
                trace.count("test.n", 2)
            hand.append((a, time.perf_counter()))
            time.sleep(0.01)
    s = trace.summary()
    outer, inner = s["spans"]["test.outer"], s["spans"]["test.inner"]
    assert outer["count"] == inner["count"] == 3
    assert outer["device_s"] is None and inner["device_s"] is None
    assert s["counts"] == {"test.n": 6}
    recs = {r["name"]: [] for r in trace.records()}
    for r in trace.records():
        recs[r["name"]].append(r)
    for r, (a, b) in zip(recs["test.outer"], hand):
        assert a <= r["host"][0] < r["host"][1] <= b
        assert r["parent"] is None
    assert [r["step"] for r in recs["test.outer"]] == [1, 2, 3]
    assert [r["step"] for r in recs["test.inner"]] == [1, 2, 3]
    assert all(r["parent"] == "test.outer" for r in recs["test.inner"])
    # totals and gaps are the records' sums; the gaps match the sleeps
    o = recs["test.outer"]
    assert outer["host_s"] == pytest.approx(
        sum(r["host"][1] - r["host"][0] for r in o), rel=1e-9)
    gap = sum(o[k]["host"][0] - o[k - 1]["host"][1] for k in (1, 2))
    assert outer["gap_s"] == pytest.approx(gap, rel=1e-9)
    hand_gap = sum(hand[k][0] - hand[k - 1][1] for k in (1, 2))
    assert 0.02 <= hand_gap <= gap <= hand_gap + 0.05
    assert 0.06 <= inner["host_s"] <= outer["host_s"]
    assert outer["host_s"] <= sum(b - a for a, b in hand)
    # the spans are ranges on the profiler's timeline
    names = {e.name for e in prof.events()}
    assert {"test.outer", "test.inner"} <= names


def test_a_new_profiler_session_starts_from_empty_totals():
    with _profile():
        with trace.span("test.first"):
            pass
    assert "test.first" in trace.summary()["spans"]
    with _profile():
        with trace.span("test.second"):
            pass
    s = trace.summary()
    assert set(s["spans"]) == {"test.second"}


def test_records_stay_bounded():
    n = trace.KEEP + 300
    with _profile():
        for i in range(n):
            with trace.span("test.many", step=i):
                pass
    s = trace.summary()
    recs = trace.records()
    assert s["spans"]["test.many"]["count"] == n
    assert len(recs) == trace.KEEP
    assert recs[-1]["step"] == n - 1 and recs[0]["step"] == n - trace.KEEP


def test_a_thread_started_before_the_profiler_counts_inside_the_loop_only():
    stop = threading.Event()
    done = []

    def work():
        while not stop.is_set():
            a = time.perf_counter()
            with trace.span("test.sample"):
                time.sleep(0.004)
                trace.count("test.drawn")
            done.append((a, time.perf_counter()))
            time.sleep(0.001)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    time.sleep(0.05)
    with _profile():
        for i in range(20):
            with trace.span("test.loop", step=i):
                time.sleep(0.005)
    # the worker keeps producing after the loop's last span, into the
    # still open session: none of that may count
    time.sleep(0.1)
    s = trace.summary()
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    first, last = s["host_interval"]
    sample = s["spans"]["test.sample"]
    covered = sum(max(0.0, min(b, last) - max(a, first)) for a, b in done)
    assert 0 < sample["host_s"] <= last - first
    assert sample["host_s"] <= covered
    # each recorded span lies inside one of the worker's own intervals;
    # only the two at the ends are cut or left out
    assert sample["host_s"] >= covered - 2 * max(b - a for a, b in done)
    assert sample["count"] <= sum(1 for a, b in done
                                  if b > first and a < last)
    drawn = s["counts"]["test.drawn"]
    assert 0 < drawn <= sum(1 for a, b in done if a < last and b > first)
    # the session is closed: more work from the thread changes nothing
    assert trace.summary() == s


def test_threads_lose_no_update():
    """More threads than cores, with a short switch interval, recording
    into one session while the loop thread's span covers them all."""
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            with trace.span("test.cover"):
                start = threading.Barrier(n_threads)

                def work():
                    start.wait(timeout=30)
                    for _ in range(n_each):
                        with trace.span("test.worker"):
                            trace.count("test.worker_n")

                ths = [threading.Thread(target=work, daemon=True)
                       for _ in range(n_threads)]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    s = trace.summary()
    assert s["spans"]["test.worker"]["count"] == n_threads * n_each
    assert s["counts"]["test.worker_n"] == n_threads * n_each


def _step_kw():
    return dict(patchshape=(5, 5, 5), num_channels=2, num_fmaps=4,
                fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                downsample_factors=((2, 2, 2),), train_code=True,
                code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 8),
                num_code_samples=16, overlapping_inst=True, max_num_inst=2,
                padding="same")


def _step_batch(size=8, batch=2):
    rng = np.random.RandomState(0)
    raw = rng.rand(batch, 2, size, size, size).astype(np.float32)
    labels = np.zeros((batch, 2) + (size + 4,) * 3, np.int32)
    labels[:, 0, 2:8, 3:9, 2:10] = 1
    labels[:, 1, 5:11, 4:10, 5:9] = 2
    return torch.from_numpy(raw), torch.from_numpy(labels)


def _one_step(model, raw, labels, traced):
    cfg = model.cfg
    tcfg = T.TrainConfig()
    opt, sched = T.make_optimizer(tcfg, model.parameters())
    step, _ = T.make_train_step(model, cfg, tcfg, opt, sched)
    gen = torch.Generator().manual_seed(3)
    if traced:
        with _profile():
            mets = step(raw, labels, gen)
    else:
        mets = step(raw, labels, gen)
    return mets, {k: p.detach().clone() for k, p in
                  model.named_parameters()}


def test_a_traced_train_step_equals_an_untraced_one_bit_for_bit():
    torch.manual_seed(0)
    model = PPPModel(PPPConfig(**_step_kw()))
    twin = copy.deepcopy(model)
    raw, labels = _step_batch()
    _close_session()
    m0, p0 = _one_step(model, raw, labels, traced=False)
    assert trace.summary()["spans"].keys() == {"test.open"}
    m1, p1 = _one_step(twin, raw, labels, traced=True)
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    s = trace.summary()
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer"} <= set(s["spans"])
    recs = {r["name"]: r for r in trace.records()}
    assert recs["train.step"]["step"] == 1
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert recs[name]["parent"] == "train.step"
        assert recs[name]["step"] == 1


def _assembly_case():
    labels = np.zeros((20, 28, 28), dtype=np.int32)
    labels[4:10, 4:12, 4:12] = 1
    labels[10:16, 14:24, 14:24] = 2
    labels[4:9, 16:24, 4:10] = 3
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    return affs, affs[13] > 0.5


def _count_synchronize(monkeypatch):
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    return calls


def test_assembly_stage_times_keep_their_keys_without_a_synchronise(
        monkeypatch):
    calls = _count_synchronize(monkeypatch)
    affs, fg = _assembly_case()
    params = VoteInstancesParams(patchshape=(3, 3, 3),
                                 removeIntersection=False)
    timings: dict = {}
    a = time.perf_counter()
    inst, _ = to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                              params, device="cpu", timings=timings)
    wall = time.perf_counter() - a
    assert set(timings) == STAGES
    assert all(v >= 0 for v in timings.values())
    assert sum(timings.values()) <= wall
    assert len(np.unique(inst[inst > 0])) == 3
    # under a profiler the stages are spans, and named ranges of the trace
    with _profile() as prof:
        to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8), params,
                        device="cpu")
    s = trace.summary()
    assert {"label." + k for k in STAGES} <= set(s["spans"])
    assert {"label." + k for k in STAGES} <= {e.name for e in prof.events()}
    assert calls == []


def test_stitch_stage_times_keep_their_keys_without_a_synchronise(
        monkeypatch):
    calls = _count_synchronize(monkeypatch)
    affs, fg = _assembly_case()
    params = VoteInstancesParams(patchshape=(3, 3, 3),
                                 removeIntersection=False)
    stats = blockwise.BlockStats()
    blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), params, chunksize=(14, 14, 14),
        device="cpu", stats=stats)
    st = stats.as_dict()["stitch_stage_seconds"]
    assert stats.stitch_windows > 0
    assert {"candidates", "windows_host", "windows_read",
            "windows_assemble", "components", "paint"} <= set(st)
    assert {"windows_assemble_" + k for k in ("consensus", "rank", "pairs",
                                              "graph")} <= set(st)
    assert sum(v for k, v in st.items()
               if not k.startswith("windows_assemble_")) \
        <= stats.stitch_seconds
    assert stats.block_stages and all(
        "read" in t and set(t) <= STAGES | {"read"}
        for t in stats.block_stages)
    assert calls == []


def test_stages_seconds_add_up_to_the_block():
    out: dict = {}
    a = time.perf_counter()
    with trace.Stages("test", None, out) as st:
        st.next("x")
        time.sleep(0.01)
        st.next("y")
        time.sleep(0.02)
        st.next("x")
        time.sleep(0.01)
    wall = time.perf_counter() - a
    assert set(out) == {"x", "y"}
    assert 0.02 <= out["x"] and 0.02 <= out["y"]
    assert out["x"] + out["y"] <= wall


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_trace.py on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_step_device_time_is_its_three_phases_on_the_card(card):
    """With the card behind the host (a sleep kernel queued first), the
    step's events and its phases' events follow one another on the
    stream: the step's device seconds are the sum of its three phases'
    within 1 %."""
    torch.manual_seed(0)
    kw = dict(_step_kw(), num_fmaps=12, train_code=False)
    model = PPPModel(PPPConfig(**kw)).to(card)
    raw, labels = _step_batch(size=48, batch=2)
    raw, labels = raw.to(card), labels.to(card)
    tcfg = T.TrainConfig()
    opt, sched = T.make_optimizer(tcfg, model.parameters())
    step, _ = T.make_train_step(model, model.cfg, tcfg, opt, sched)
    gen = torch.Generator(device=card).manual_seed(3)
    for _ in range(2):
        step(raw, labels, gen)
    torch.cuda.synchronize(card)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        with trace.span("test.warm", card):
            pass
        for _ in range(3):
            torch.cuda._sleep(200_000_000)
            step(raw, labels, gen)
        torch.cuda.synchronize(card)
    s = trace.summary()["spans"]
    parts = sum(s[k]["device_s"] for k in ("train.forward", "train.backward",
                                           "train.optimizer"))
    whole = s["train.step"]["device_s"]
    assert s["train.step"]["count"] == 3
    assert whole > 0 and abs(whole - parts) <= 0.01 * whole
    recs = [r for r in trace.records() if r["name"] == "train.step"]
    for r in recs:
        d0, d1 = r["device"]
        assert d0 < d1
