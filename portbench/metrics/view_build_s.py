"""Host seconds spent building the graph's derived views before the
window (the reverse sliced-ELL view and its sweep plan, the fingerprint,
...): the program's outermost `view` spans (`GraphContext.view` on a
miss) that ended before the window opened."""
from portbench import spans


def read(run):
    recs, t0 = spans.program_records(run), spans.window_start_ns(run)
    if recs is None or t0 is None:
        return None
    views = {r.id for r in recs if r.name == "view"}
    built = [r for r in recs if r.name == "view" and r.end_ns <= t0 and r.parent not in views]
    return sum(r.end_ns - r.start_ns for r in built) / 1e9 if built else None
