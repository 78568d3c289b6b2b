"""The port's autotuner against the reference's: mirrors
tests/test_autotune.py without its distributed case. The pure pieces
(`source_digest`, `search_space(stats)`, `stats_distance`) must equal the
reference's on the same graphs; the store's JSON must round-trip between
the two packages, keyed by backend. The measure loop runs with a
deterministic cost model (`fake_measure`), as the reference's tests do."""
import dataclasses
import json

import numpy as np
import pytest

import repro.autotune as rat
import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.graph.algorithms_ref import sssp_ref
from repro_torch.autotune import (TuningRecord, TuningStore, autotune, default_params,
                                  measure_wallclock, nearest_record, schedule_from_dict,
                                  schedule_to_dict, search_space, source_digest,
                                  stats_distance)
from repro_torch.schedule import Schedule


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


@pytest.fixture(scope="module")
def pl():
    g = rg.preferential_attachment(300, m=5, seed=3)
    return g, carry(g)


@pytest.fixture(scope="module")
def road():
    g = rg.road(32, seed=7)
    return g, carry(g)


@pytest.fixture(scope="module", params=["local", "cuda"])
def sssp_prog(request):
    return tc.compile_bundled("sssp", backend=request.param)


def fake_measure(bound, params):
    """Deterministic, schedule-dependent cost: no wall clock involved."""
    s = bound.program.schedule
    return 1.0 + (hash(s) % 1000) / 1000.0


def as_dicts(cands):
    return [dataclasses.asdict(c) for c in cands]


# --- the pure pieces against the reference ---------------------------------------

def test_digest_matches_reference():
    for name in tc.bundled_programs():
        src = tc.load_program_source(name)
        assert source_digest(src) == rat.source_digest(src)
        assert src == rc.load_program_source(name)


@pytest.mark.parametrize("backend", ["local", "distributed"])
@pytest.mark.parametrize("tune_batch", [False, True])
@pytest.mark.parametrize("gname", ["pl", "road"])
def test_search_space_matches_reference(gname, tune_batch, backend, request):
    g, tgr = request.getfixturevalue(gname)
    stats = tc.get_context(tgr).stats()
    assert stats == rc.get_context(g).stats()
    got = search_space(stats, tune_batch=tune_batch, backend=backend)
    want = rat.search_space(stats, tune_batch=tune_batch, backend=backend)
    assert as_dicts(got) == as_dicts(want)
    base = Schedule(priority="delta", delta_bucket=16, block_rows=(8, 16, 32, 64))
    rbase = rc.Schedule(**dataclasses.asdict(base))
    assert as_dicts(search_space(stats, base, backend=backend)) == \
        as_dicts(rat.search_space(stats, rbase, backend=backend))


def test_search_space_base_first_and_pruned_by_family(pl, road):
    p = search_space(tc.get_context(pl[1]).stats())
    r = search_space(tc.get_context(road[1]).stats())
    assert p[0] == Schedule() and len(p) == len(set(p))
    assert any(c.num_buckets >= 5 for c in p) and any(c.num_buckets == 1 for c in r)
    assert any(c.direction == "push" for c in r) and not any(c.direction == "push" for c in p)
    assert any(c.priority == "delta" for c in r)


def test_stats_distance_and_nearest_record_match_reference(pl, road, tmp_path):
    sp, sr = tc.get_context(pl[1]).stats(), tc.get_context(road[1]).stats()
    assert stats_distance(sp, sr) == rat.stats_distance(sp, sr)
    assert stats_distance(sp, sp) == 0.0
    prog = tc.compile_bundled("sssp", backend="cuda")
    path = str(tmp_path / "t.json")
    autotune(prog, pl[1], budget=3, measure=fake_measure, store=path)
    autotune(prog, road[1], budget=3, measure=fake_measure, store=path)
    store = TuningStore(path)
    g_probe = carry(rg.preferential_attachment(300, m=5, seed=21))
    probe = tc.get_context(g_probe).stats()
    digest = source_digest(prog.dsl_source)
    rec = nearest_record(store, digest, "cuda", probe)
    assert rec.graph_fingerprint == tc.get_context(pl[1]).fingerprint()
    assert nearest_record(store, digest, "local", probe) is None
    want = rat.nearest_record(rat.TuningStore(path), digest, "cuda", probe)
    assert want.graph_fingerprint == rec.graph_fingerprint


# --- the store: JSON shared with the reference, keyed by backend --------------------

def test_store_json_round_trips_between_the_packages(pl, tmp_path):
    g, tgr = pl
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    prog = tc.compile_bundled("sssp", backend="cuda")
    rec = autotune(prog, tgr, budget=4, measure=fake_measure, store=mine).record
    loaded = rat.TuningStore(mine)
    (rrec,) = loaded.records()
    assert rrec.to_dict() == rec.to_dict()
    assert rrec.best_schedule() == rc.Schedule(**rec.schedule)
    # the reference writes, the port reads
    rprog = rc.compile_bundled("sssp", backend="local")
    want = rat.autotune(rprog, g, budget=4, measure=fake_measure, store=theirs).record
    (got,) = TuningStore(theirs).records()
    assert got.to_dict() == want.to_dict()
    assert got.best_schedule() == Schedule(**want.schedule)
    # a port `local` run reads the reference's `local` record: same digest,
    # same fingerprint, same backend name
    hit = autotune(tc.compile_bundled("sssp", backend="local"), tgr, budget=4,
                   measure=fake_measure, store=theirs)
    assert hit.from_store and hit.record.to_dict() == want.to_dict()


def test_records_are_keyed_by_backend(pl, tmp_path):
    _, tgr = pl
    path = str(tmp_path / "t.json")
    prog = tc.compile_bundled("sssp", backend="cuda")
    autotune(prog, tgr, budget=3, measure=fake_measure, store=path)
    digest, fp = source_digest(prog.dsl_source), tc.get_context(tgr).fingerprint()
    for store in (TuningStore(path), rat.TuningStore(path)):
        assert store.lookup(digest, "cuda", fp) is not None
        assert store.lookup(digest, "local", fp) is None
        assert store.lookup(digest, "pallas", fp) is None
    calls = []
    r = autotune(tc.compile_bundled("sssp", backend="local"), tgr, budget=3,
                 measure=lambda b, p: calls.append(1) or fake_measure(b, p), store=path)
    assert not r.from_store and len(calls) == 3


def test_schedule_dict_round_trip_through_json():
    for s in (Schedule(), Schedule(block_rows=(64, 64, 128, 256)),
              Schedule(priority="delta", delta_bucket=7)):
        assert schedule_from_dict(json.loads(json.dumps(schedule_to_dict(s)))) == s
    d = schedule_to_dict(Schedule())
    d["warp_size"] = 32
    with pytest.raises(ValueError, match="warp_size"):
        schedule_from_dict(d)


def test_tuning_store_concurrent_writers_merge(tmp_path):
    path = str(tmp_path / "store.json")
    rec = lambda d, s: TuningRecord(  # noqa: E731
        source_digest=d, backend="cuda", graph_fingerprint="f" * 16, fn_name="f",
        schedule=schedule_to_dict(s), best_ms=1.0, default_ms=2.0, trials=[],
        budget=1, seed=0)
    a, b = TuningStore(path), TuningStore(path)
    a.put(rec("a" * 16, Schedule()))
    a.save()
    b.put(rec("b" * 16, Schedule(direction="pull")))
    b.save()
    assert len(TuningStore(path)) == 2 and len(rat.TuningStore(path)) == 2


# --- the tuner ----------------------------------------------------------------------

def test_autotune_deterministic_and_truncated(sssp_prog, pl):
    _, tgr = pl
    r1 = autotune(sssp_prog, tgr, budget=6, seed=0, measure=fake_measure)
    r2 = autotune(sssp_prog, tgr, budget=6, seed=0, measure=fake_measure)
    assert r1.schedule == r2.schedule and r1.record.trials == r2.record.trials
    assert len(r1.record.trials) == 6
    assert r1.record.trials[0]["schedule"] == schedule_to_dict(sssp_prog.schedule)
    assert r1.record.best_ms <= r1.record.default_ms and r1.speedup >= 1.0
    assert r1.record.backend == sssp_prog.backend


def test_autotune_result_correct_and_cached(sssp_prog, pl):
    g, tgr = pl
    r = autotune(sssp_prog, tgr, budget=6, seed=0, measure=fake_measure)
    out = r.program.bind(tgr)(src=0)["dist"].numpy()
    assert np.array_equal(out, sssp_ref(g, 0).astype(np.int32))
    size = tc.compile_cache_size()
    autotune(sssp_prog, tgr, budget=6, seed=0, measure=fake_measure)
    assert tc.compile_cache_size() == size
    assert sssp_prog.recompile(sssp_prog.schedule) is sssp_prog


def test_store_hit_skips_measurement(sssp_prog, pl, tmp_path):
    _, tgr = pl
    path = str(tmp_path / "tuned.json")
    r1 = autotune(sssp_prog, tgr, budget=4, measure=fake_measure, store=path)
    assert not r1.from_store
    calls = []
    counting = lambda b, p: calls.append(1) or fake_measure(b, p)  # noqa: E731
    r2 = autotune(sssp_prog, tgr, budget=4, measure=counting, store=path)
    assert r2.from_store and not calls and r2.schedule == r1.schedule


@pytest.mark.parametrize("field,value", [("source_digest", "0badc0ffee0badc0"),
                                         ("graph_fingerprint", "0badc0ffee0badc0"),
                                         ("schedule", {"direction": "sideways"})])
def test_store_rejects_a_tampered_record(sssp_prog, pl, tmp_path, field, value):
    """A record whose digest or fingerprint no longer matches, or whose
    schedule no longer validates, is a miss: the tuner re-measures."""
    _, tgr = pl
    path = str(tmp_path / "tuned.json")
    autotune(sssp_prog, tgr, budget=4, measure=fake_measure, store=path)
    with open(path) as f:
        data = json.load(f)
    data["records"][0][field] = value
    with open(path, "w") as f:
        json.dump(data, f)
    calls = []
    r = autotune(sssp_prog, tgr, budget=4,
                 measure=lambda b, p: calls.append(1) or fake_measure(b, p), store=path)
    assert not r.from_store and len(calls) == 4


def test_corrupt_store_file_is_a_miss_not_a_crash(sssp_prog, pl, tmp_path):
    path = str(tmp_path / "tuned.json")
    with open(path, "w") as f:
        f.write('{"version": 1, "records": [{"trunc')
    r = autotune(sssp_prog, pl[1], budget=3, measure=fake_measure, store=path)
    assert not r.from_store and len(r.record.trials) == 3
    assert len(TuningStore(path)) == 1


def test_autotune_seeds_unseen_graph_from_store(sssp_prog, pl, tmp_path):
    _, tgr = pl
    path = str(tmp_path / "tuned.json")
    r1 = autotune(sssp_prog, tgr, budget=6, measure=fake_measure, store=path)
    g2 = carry(rg.preferential_attachment(300, m=5, seed=11))
    rec = autotune(sssp_prog, g2, budget=6, measure=fake_measure, store=path).record
    assert rec.seeded_from == tc.get_context(tgr).fingerprint()
    assert rec.trials[0]["source"] == "seeded"
    assert schedule_from_dict(rec.trials[0]["schedule"]) == r1.schedule
    assert rec.best_ms <= rec.default_ms


def test_default_params_from_ir(pl):
    _, tgr = pl
    assert default_params(tc.compile_bundled("sssp"), tgr) == {"src": 0}
    p = default_params(tc.compile_bundled("bc"), tgr, seed=0)
    want = rat.default_params(rc.compile_bundled("bc"), pl[0], seed=0)
    assert p["sourceSet"].dtype == np.int32
    assert np.array_equal(p["sourceSet"], want["sourceSet"])
    p = default_params(tc.compile_bundled("pr"), tgr)
    assert p["maxIter"] == 20 and 0 < p["delta"] < 1


def test_measure_wallclock_times_a_bound_call(pl):
    _, tgr = pl
    secs = measure_wallclock(tc.compile_bundled("sssp", backend="cuda").bind(tgr),
                             {"src": 0}, warmup=1, reps=2)
    assert 0 < secs < 60


def test_autotune_of_a_distributed_program_names_its_item(pl):
    prog = tc.compile_bundled("sssp", backend="distributed")
    with pytest.raises(NotImplementedError, match="item 11d"):
        autotune(prog, pl[1], budget=2, measure=fake_measure)
