"""Host time a query spent compiling (plan cache lookup, or filtering,
ordering, encoding and the plan on a miss), `MatchOutcome.compile_s`, in
ms a query over the window."""


def read(rec):
    if not rec["queries"]:
        return None
    return rec["compile_s"] * 1e3 / rec["queries"]
