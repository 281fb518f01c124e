"""Mean of `FinetuneTrainer.logs["learn_s"]` over the window's
iterations (bucketing, upload, loss, backward, AdamW, the loss read), in
ms."""


def read(record: dict):
    xs = record["learn_s"]
    return 1e3 * sum(xs) / len(xs) if xs else None
