"""Share of the window's records that the program's ``sort_device``
sorted by its stable fallback, in %: its counters ``fallback_records``
over ``records`` (``core/learned_sort.py``), which
``kernels.ops.reset_launches()`` sets to 0 just before the window.  None
where no call was counted: a control in the program's place, or a
program without the counters."""


def read(ctx):
    from repro_torch.core import learned_sort

    records = getattr(learned_sort.sort_device, "records", 0)
    if not records:
        return None
    return 100.0 * learned_sort.sort_device.fallback_records / records
