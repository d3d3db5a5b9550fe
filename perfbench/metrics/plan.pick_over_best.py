"""plan.pick_over_best: the device time of a pass's dense products at the
planned tiles over their time at the fastest of each product's pick and
the planner's next two ranked tiles (CUDA events, in turns, after the
window); 1 where the planner picks the fastest."""


def read(rec):
    plan = rec.get("plan") if rec.get("kind") == "gemm_pass" else None
    if not plan:
        return None
    picked = sum(p["count"] * p["tile_s"][0] for p in plan)
    best = sum(p["count"] * min(p["tile_s"]) for p in plan)
    return picked / best if best > 0 else None
