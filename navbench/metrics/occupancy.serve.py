"""Mean batch occupancy over the window: the steps NavServer served over
its batches' slots (`NavServer.stats()` at the window's start and end),
in %."""


def read(record: dict):
    s0, s1 = record["stats"]
    batches = s1["batches"] - s0["batches"]
    if batches <= 0:
        return None
    steps = s1["steps_served"] - s0["steps_served"]
    return 100.0 * steps / (batches * record["max_batch"])
