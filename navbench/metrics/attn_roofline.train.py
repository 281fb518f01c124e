"""Roofline share of attention in the traced stretch: the least time of
the attention work the model did (its calls' shapes, forward and, where
autograd recorded, backward: `navbench/trace.py`) over the device time
of the kernels that compute attention (names holding `attention_fwd` or
`attention_bwd`: K-ATT and K-ATT-BWD), in %."""


def read(record: dict):
    dev = record["trace"]["attention_s"]
    if dev <= 0 or record["attention_bound_s"] <= 0:
        return None
    return 100.0 * record["attention_bound_s"] / dev
