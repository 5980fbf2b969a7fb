"""The port's stage spans and counter record (``utils/stagetimer.py``).

On the CPU: under ``torch.profiler`` every stage is a ``flooder.*`` span,
nested as the stages nest and inside the call, with no device fence; with
the profiler off and ``FLOODER_TIMING`` unset a stage opens no span and
prints nothing and counts nothing; ``FLOODER_TIMING`` keeps its fenced
lines; and while tracing each call's counter record holds what the call
decided. The card case (no span casts
a shadow on the device timeline; K1's and K2's device counters) is marked
``cuda`` and skips here; it imports nothing of JAX, so on a machine
without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import builtins
import re

import pytest
import torch

import flooder_tpu_torch as ft
from flooder_tpu_torch import core
from flooder_tpu_torch.core import _grid_host
from flooder_tpu_torch.ops import cuda_flood as cf
from flooder_tpu_torch.ops.flood import simplex_bounding_balls
from flooder_tpu_torch.parallel import make_mesh
from flooder_tpu_torch.utils import stagetimer

# The stages of a 3-D grid-mode call and its persistence, child -> parent
# (None: the stage is outermost).
STAGES = {
    "fps": None, "landmarks-d2h": None, "engine-init": None,
    "engine-init:kd-order": "engine-init",
    "engine-init:permute+boxes": "engine-init", "delaunay": None,
    "dim3:balls+order": None, "dim3:distances": None,
    "prep:operands": "dim3:distances", "prep:worklist": "dim3:distances",
    "kernel": "dim3:distances", "dim3:assembly": None, "monotonicity": None,
    "persistence": None,
}
# The fenced line's form, as the benchmark parses it (fbench/trace.py).
LINE = re.compile(r"^\[flooder-timing\] ([^:\s][^\s]*?): ([0-9.eE+-]+)s$")


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    """Tracing off and torch on one thread, whatever the environment."""
    monkeypatch.setattr(stagetimer, "ENABLED", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed=0, n=600):
    return torch.rand(n, 3, generator=torch.Generator().manual_seed(seed))


def _call(X, **kw):
    kw.setdefault("return_simplex_tree", True)
    return ft.flood_complex(X, 24, points_per_edge=5, device="cpu", **kw)


def _span_events(prof):
    """(name, start, end) of the profiler's events, host and device."""
    return [(e.name(), str(e.device_type()), int(e.start_ns()),
             int(e.start_ns()) + int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()]


def test_profiler_spans_nest_inside_the_call_with_no_fence(monkeypatch):
    fences = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: fences.append(1))
    X = _cloud()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("call"):
            _call(X).persistence()
            _call(_cloud(1), return_simplex_tree=False)
            _call(_cloud(2), mesh=make_mesh(["cpu"] * 4, simplex_parallel=2))
    events = _span_events(prof)
    (call,) = [(s, e) for n, _, s, e in events if n == "call"]
    spans = [(n[len("flooder."):], kind, s, e) for n, kind, s, e in events
             if n.startswith("flooder.")]
    names = {n for n, *_ in spans}
    assert names == set(STAGES) | {"dict-out", "prep:shards"}
    assert all(kind.endswith("CPU") for _, kind, _, _ in spans)
    for name, _, s, e in spans:
        assert call[0] <= s <= e <= call[1], name
        parent = STAGES.get(name)
        if parent is not None:
            assert any(p == parent and ps <= s and e <= pe
                       for p, _, ps, pe in spans), (name, parent)
    assert not fences


def test_no_span_and_no_print_when_tracing_is_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a stage traced with tracing off")

    monkeypatch.setattr(stagetimer, "_span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    X = _cloud()
    stagetimer.reset_counters()
    monkeypatch.setattr(builtins, "print", refuse)
    _call(X).persistence()
    _call(X)
    monkeypatch.undo()
    # no record opened, nothing counted, no device counter kept
    assert stagetimer.records() == [
        {"mode": "off", "counters": {}, "stage_s": {}}]


def test_fenced_lines_keep_their_form_and_add_persistence(monkeypatch,
                                                          capsys):
    X = _cloud()
    monkeypatch.setattr(stagetimer, "ENABLED", True)
    _call(X).persistence()
    lines = capsys.readouterr().err.strip().splitlines()
    assert lines and all(LINE.match(line) for line in lines), lines
    assert [LINE.match(line).group(1) for line in lines] == [
        "fps", "landmarks-d2h", "engine-init:kd-order",
        "engine-init:permute+boxes", "engine-init", "delaunay",
        "dim3:balls+order", "prep:operands", "prep:worklist", "kernel",
        "dim3:distances", "dim3:assembly", "monotonicity", "persistence"]
    assert stagetimer.records()[-1]["mode"] == "fenced"


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_the_record_counts_the_witnesses_and_the_cache_hits():
    X = _cloud(n=700)
    with _profiled():
        _call(X)
        first = stagetimer.counters()
        _call(X)
        again = stagetimer.counters()
        _call(X.clone())
        new = stagetimer.counters()
    assert first == {"witnesses_real": 700,
                     "witnesses_padded": cf.witness_total(700),
                     "k1_inball_pairs": first["k1_inball_pairs"]}
    assert cf.witness_total(700) == 2048 and first["k1_inball_pairs"] > 0
    assert again["engine_cache_hit"] == 1 and "witnesses_real" not in again
    assert "engine_cache_hit" not in new and new["witnesses_real"] == 700


def _pass_operands(n=800, lms=20):
    X = _cloud(3, n)
    L = X[torch.randperm(n, generator=torch.Generator().manual_seed(4))[:lms]]
    from flooder_tpu_torch.topology import DelaunayComplex

    tets = DelaunayComplex(L.double().numpy()).create_simplex_tree()._verts[3]
    sv = L[torch.as_tensor(tets).long()]
    c, r = simplex_bounding_balls(sv)
    return cf.CudaFloodEngine(X), sv, _grid_host(6, 3)[0], c, r


def test_count_and_keep_do_nothing_with_tracing_off():
    stagetimer.reset_counters()
    stagetimer.new_record()
    stagetimer.count("probe", 3)
    stagetimer.keep("kept", torch.ones(2, 2, dtype=torch.int64))
    cf.CudaFloodEngine(_cloud(3, 800))
    assert stagetimer.counters() == {} and len(stagetimer.records()) == 1
    with _profiled():
        stagetimer.count("probe", 3)
        stagetimer.keep("kept", torch.ones(2, 2, dtype=torch.int64), 1)
        cf.CudaFloodEngine(_cloud(3, 800))
    got = stagetimer.counters()
    assert (got["probe"], got["kept"]) == (3, 2)
    assert got["witnesses_padded"] == cf.witness_total(800)


def test_k1_device_counters_are_its_stats_and_kept_only_while_tracing():
    engine, sv, w, c, r = _pass_operands()
    stagetimer.reset_counters()
    engine.min_distances(sv, w, c, r, tight=True)
    assert "k1_inball_pairs" not in stagetimer.counters()
    with _profiled():
        engine.min_distances(sv, w, c, r, tight=True)
        engine.min_distances(sv, w, c, r, tight=True)
    _, pairs = cf.kernel_operations(engine.last_stats)
    assert pairs > 0
    assert stagetimer.counters() == {"k1_inball_pairs": 2 * pairs}


def test_reset_counters_zeroes_the_record():
    with _profiled():
        stagetimer.count("anything", 5)
    assert stagetimer.counters()["anything"] == 5
    stagetimer.reset_counters()
    assert stagetimer.counters() == {}
    assert [r["counters"] for r in stagetimer.records()] == [{}]


def test_records_keep_the_mode_and_stay_bounded():
    stagetimer.reset_counters()
    with _profiled():
        for _ in range(stagetimer.HISTORY + 3):
            stagetimer.new_record()
    assert len(stagetimer.records()) == stagetimer.HISTORY
    with _profiled():
        stagetimer.new_record()
        with stagetimer.stage("probe"):
            stagetimer.count("probe")
    last = stagetimer.records()[-1]
    assert last["mode"] == "profiler" and last["counters"] == {"probe": 1}
    assert last["stage_s"]["probe"] >= 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_cast_no_device_shadow_and_device_counters_resolve(
        cuda_device):
    from flooder_tpu_torch.ops import cuda_fps

    X = torch.rand(20000, 3, generator=torch.Generator().manual_seed(5)
                   ).to(cuda_device)
    _ = ft.flood_complex(X, 64, points_per_edge=6)  # build, warm up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st = ft.flood_complex(X.clone(), 64, points_per_edge=6,
                              return_simplex_tree=True)
        st.persistence()
    got = stagetimer.counters()
    events = _span_events(prof)
    host = {n for n, kind, *_ in events if n.startswith("flooder.")
            and kind.endswith("CPU")}
    assert host >= {"flooder." + n for n in STAGES}
    assert not [n for n, kind, *_ in events if n.startswith("flooder.")
                and kind.endswith("CUDA")]
    assert got["k2_chunk_visits"] == int(cuda_fps.last_visits.item()) > 0
    _, pairs = cf.kernel_operations(core._ENGINE_CACHE[-1][2].last_stats)
    assert got["k1_inball_pairs"] == pairs > 0
