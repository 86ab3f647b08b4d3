"""The comparison that decides ``correct``: each call's outputs and
report against the plain reference's."""

READ_COUNTS = ("input", "output", "read1_with_adapter", "read2_with_adapter")
BASEPAIR_COUNTS = ("input", "input_read1", "input_read2", "quality_trimmed",
                   "quality_trimmed_read1", "quality_trimmed_read2", "output",
                   "output_read1", "output_read2")


def report_summary(report: dict) -> dict:
    """The read and base-pair counts and the 3' adapter statistics of a
    cutadapt ``--json`` report, in the shape reference.trim.run gives."""
    rc = report["read_counts"]
    adapters = []
    for side in ("adapters_read1", "adapters_read2"):
        for a in report.get(side) or []:
            end = a["three_prime_end"]
            adapters.append({
                "matches": end["matches"],
                "adjacent_bases": end["adjacent_bases"],
                "trimmed_lengths": [[row["len"], row["counts"]]
                                    for row in end["trimmed_lengths"]],
            })
    return {
        "read_counts": dict(
            {k: rc[k] for k in READ_COUNTS},
            too_short=rc["filtered"]["too_short"],
        ),
        "basepair_counts": {k: report["basepair_counts"][k]
                            for k in BASEPAIR_COUNTS},
        "adapters": adapters,
    }


def differences(got, want, path="") -> list:
    """The paths at which two summaries differ."""
    if isinstance(want, dict) and isinstance(got, dict):
        out = []
        for key in sorted(set(want) | set(got), key=str):
            out += differences(got.get(key), want.get(key), f"{path}.{key}")
        return out
    if isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += differences(g, w, f"{path}[{i}]")
        return out
    return [] if got == want else [path or "."]


def first_difference(got: list, want: list):
    """The index of the first digest block that differs (a length
    difference counts at the shorter's end), or None."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))
