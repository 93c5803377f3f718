"""Mean device ms of the window's 3DGS-MCMC relocations (relocation and
growth together, between CUDA events the Trainer records around them;
its `relocate` records in Trainer.events)."""


def read(record: dict) -> float | None:
    ms = [e["device_ms"] for e in record.get("relocations") or ()]
    return sum(ms) / len(ms) if ms else None
