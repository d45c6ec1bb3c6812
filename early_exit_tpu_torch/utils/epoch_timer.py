"""Epoch timing helper (counterpart of `early_exit_tpu/utils/epoch_timer.py`,
the reference's util/epoch_timer.py)."""


def epoch_time(start_time: float, end_time: float):
    """(whole minutes, remaining whole seconds) between two clock readings."""
    elapsed = end_time - start_time
    mins = int(elapsed / 60)
    secs = int(elapsed - mins * 60)
    return mins, secs
