"""Share of the slots that the ranks' ``sort_device`` sorted over the
window that held no record, in %: ``1 - sum n_valid / sum records``, the
program's counter ``sort_device.records`` (``core/learned_sort.py``,
set to 0 just before the window) against the records in the answers.
The route's capacity padding, sorted with the records.  None where no
call was counted (a control in the program's place)."""


def read(ctx):
    ranks = getattr(ctx, "ranks", [])
    slots = sum(r.sort_records for r in ranks)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(r.n_valid for r in ranks) / slots)
