"""The mean M of a held expert's product: the token-expert rows the held
experts computed over the expert groups that had a row (`moe_rows` /
`moe_groups` from `NavServer.stats()` at the window's start and end),
summed over the window's encodes and expert layers. None where the
program has no such counters."""


def read(record: dict):
    s0, s1 = record["stats"]
    if "moe_rows" not in s1 or "moe_rows" not in s0:
        return None
    groups = s1["moe_groups"] - s0["moe_groups"]
    if groups <= 0:
        return None
    return (s1["moe_rows"] - s0["moe_rows"]) / groups
