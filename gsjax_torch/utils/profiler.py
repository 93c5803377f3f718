"""torch.profiler sessions that record every kernel the card runs in them.

On the card a torch.profiler session loses device records two ways
(PERF.md §6, fault F4):
* after a training run in the same process, the first kernel launches
  after recording starts (the first four in most sessions, now and then
  all): lost by launch order, whatever the time before them;
* in any process, now and then, the kernels at either end of the
  recorded window: the profiler keeps only device records whose times,
  moved onto the host's clock, fall inside the window, and that move is
  off by up to about 2 ms.
So every session of the port opens with the profiler's own warm-up step
(torch.profiler.schedule: warm-up 1, active 1), in which LEAD_IN short
kernels run while the profiler traces without recording, and the host
idles PAUSE_S after the recorded step starts and before it ends. The
lead-in's kernels are LEAD_IN_KERNEL's, which no other code of the port
launches; readers leave out any that reach the record (is_lead_in).

    prof = start_session(activities)
    ...                      # the work to record
    stop_session(prof)       # then prof.events(), key_averages(), export
"""

from __future__ import annotations

import time

import torch

# Launches of the warm-up step: more than any loss by launch order seen.
LEAD_IN = 64
# torch.cuda._sleep's kernel, the lead-in's.
LEAD_IN_KERNEL = "spin_kernel"
# The host's idle time at each end of the recorded step: ten times the
# largest clock error seen.
PAUSE_S = 0.02


def is_lead_in(name: str) -> bool:
    """Whether a device event of this name is a lead-in's kernel."""
    return LEAD_IN_KERNEL in name


def start_session(activities):
    """A started torch.profiler.profile over `activities` whose warm-up
    step has run (where CUDA is traced: LEAD_IN spin kernels, the card
    synchronized) and whose recorded step has begun (where CUDA is traced:
    after PAUSE_S); what runs until stop_session(prof) is recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = ProfilerActivity.CUDA in activities
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    if cuda:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    prof.step()
    if cuda:
        time.sleep(PAUSE_S)
    return prof


def stop_session(prof) -> None:
    """End the recorded step (where CUDA is traced: the card synchronized,
    then PAUSE_S) and the session."""
    from torch.profiler import ProfilerActivity

    if ProfilerActivity.CUDA in prof.activities:
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
    prof.step()
    prof.stop()
