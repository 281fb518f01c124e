"""Mean of `FinetuneTrainer.logs["rollout_s"]` over the window's
iterations, in s."""


def read(record: dict):
    xs = record["rollout_s"]
    return sum(xs) / len(xs) if xs else None
