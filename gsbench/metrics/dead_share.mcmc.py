"""Mean % of the alive Gaussians that the window's 3DGS-MCMC relocations
found dead (opacity at most 0.005) and moved: n_dead over n_alive of each
`relocate` record in Trainer.events."""


def read(record: dict) -> float | None:
    shares = [e["n_dead"] / e["n_alive"] for e in record.get("relocations") or () if e["n_alive"]]
    return 100.0 * sum(shares) / len(shares) if shares else None
