"""The LF walk's share of its memory roofline, in %: the least time the
bytes of its work need at the card's memory rate (``peaks.json``) over
``walk_busy_ms.locate`` (the device time of the ``fmindex.walk`` span) in
the same traced window.  The bytes come from the work, not the program's
layout (:func:`work_bytes`), so that a walk of another design is read on
the same work: the row steps per call from ``walk_row_steps.locate``, the
located rows per call from ``rows.locate``.  None where the card is not in
``peaks.json``, or where the row steps, the rows or the walk's busy time
are not read."""
from fmbench import probe_join, spans


def work_bytes(row_steps: float, rows: float) -> float:
    """Bytes the walk must move for a call whose located rows take
    ``row_steps`` LF steps in all: each step reads the 128-position block
    that holds its row, its planes at 2 bits a symbol (32 B) and the block's
    4-B count of the symbol found; each located row is read once (8 B), its
    sampled-SA entry read once (4 B) and its u32 position written once
    (4 B).  A row's position between steps is the walk's own state, not
    work, so ``36 * row_steps + 16 * rows``."""
    return 36.0 * row_steps + 16.0 * rows


def read(run):
    peak = probe_join.peak_bytes_per_s(run)
    got = spans.counts()
    if peak is None or got is None or "rows" not in got or "walk_row_steps" not in got:
        return None
    row_steps = spans.per_call(run, "walk_row_steps")
    rows = spans.per_call(run, "rows")
    busy_ms = spans.busy_ms(run, "fmindex.walk")
    if row_steps is None or rows is None or not busy_ms:
        return None
    return 100.0 * work_bytes(row_steps, rows) / peak / (busy_ms * 1e-3)
