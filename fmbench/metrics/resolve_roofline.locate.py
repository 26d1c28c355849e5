"""Resolve's share of its memory roofline, in %: the least time the bytes
of its work need at the card's memory rate (``peaks.json``) over
``resolve_busy_ms.locate`` (the device time of the ``fmindex.resolve``
span) in the same traced window.  The bytes come from the work, not the
program's layout (:func:`work_bytes`); the patterns per call from the run's
pool, the rows per call from ``rows.locate``.  None where the card is not
in ``peaks.json``, or where the rows or resolve's busy time are not read."""
from fmbench import probe_join, spans


def work_bytes(patterns: float, rows: float) -> float:
    """Bytes resolve must move for a call of ``patterns`` patterns that
    locates ``rows`` rows: 8 B a pattern (its range, two u32 rows in) and
    12 B a located row (its u32 SA entry in; its u32 position and u32
    pattern id out), so ``8 * patterns + 12 * rows``."""
    return 8.0 * patterns + 12.0 * rows


def read(run):
    peak = probe_join.peak_bytes_per_s(run)
    got = spans.counts()
    if peak is None or got is None or "rows" not in got:
        return None
    rows = spans.per_call(run, "rows")
    busy_ms = spans.busy_ms(run, "fmindex.resolve")
    if rows is None or not busy_ms:
        return None
    patterns = sum(int(pats.shape[0]) for pats, _ in run.pool) / len(run.pool)
    return 100.0 * work_bytes(patterns, rows) / peak / (busy_ms * 1e-3)
