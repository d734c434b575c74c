"""The comparison that decides ``correct``: each number beside its limit
(``workloads/<cell>.json``, set from the readings in PERF.md)."""
from __future__ import annotations

import statistics


def same_layout(W, program_specs):
    """The benchmark's weight layout has the names and shapes the
    program's ``model_specs`` asks for."""
    def shapes(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(shapes(v, f"{pre}/{k}"))
            return out
        return {pre: tuple(t.shape)}
    a, b = shapes(W), shapes(program_specs)
    if a != b:
        diff = sorted(set(a.items()) ^ set(b.items()))[:8]
        raise SystemExit(f"weight layout differs from the program's: {diff}")


def leaf_gaps(got, ref, leaves):
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(got[n] - ref[n]) / max(ref[n], med) for n in leaves}


def _leaf_gap(got, ref, leaves):
    return max(leaf_gaps(got, ref, leaves).values())


def train_values(got, ref):
    """Loss of each followed step (relative gap, worst step), the first
    clipped gradient and the parameters' change (worst leaf).  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of the change."""
    names = list(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(got["grad"], ref["grad"], names),
        "change_gap": _leaf_gap(got["change"], ref["change"], moved),
    }


def train_numbers(got, ref, limits):
    """The values that have a limit, each beside it."""
    vals = train_values(got, ref)
    return {k: {"value": vals[k], "limit": v} for k, v in limits.items()}


def logit_gaps(ref_logits, tokens):
    """How far each token's reference logit lies below the reference's
    best at its position."""
    best = ref_logits.max(dim=-1).values
    return (best - ref_logits.gather(1, tokens[:, None]).squeeze(1))


def serve_numbers(gaps, limits):
    return {"logit_gap": {"value": max(gaps), "limit": limits["logit_gap"]}}


def verdict(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())

