"""Host ms per Trainer window outside the windows the Trainer records
(Trainer.events: from its window's dispatch to its one host sync): the
budget check, the bookkeeping and the loop between windows."""


def read(record: dict) -> float | None:
    calls = record.get("trainer_calls")
    windows = sum(len(ms) for _, ms in calls or ())
    if not windows:
        return None
    return sum(wall * 1e3 - sum(ms) for wall, ms in calls) / windows
