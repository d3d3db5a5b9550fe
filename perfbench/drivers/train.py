"""Driver ``train``: full-width training steps of a dense decoder.

The benchmark makes the parameters in float32 from the seed
(``reference/dense_lm.py``'s ``make_params``) and hands them to the
program's step, ``repro_torch.runtime.train_lib.make_train_step`` (remat
per layer, AdamW with float32 masters and moments, bf16 compute), which
updates them in place.  Set-up builds that one step and its state, and
drives it through the traffic's ``check_steps`` first steps on batches of
token ids drawn from the seed (every row different); those steps are the
warm-up.  The window then goes on stepping the same state on further
batches.  A traced run runs the same untraced window and then traces
:data:`TRACE_STEPS` more steps: device time comes from the traced steps,
the step's pace from the window.

What the reference checks: the first steps' losses, each leaf's first
clipped gradient (from the first moment after one step) and each leaf's
change over those steps, all from the seed's parameters; and the same of
one more step that the same object makes after the window has closed, on
the next batch of the window's rotation, from a copy of the program's
state as the window left it (its parameters, moments and step count): so
the check sees the state after every step of the window, at the learning
rate the schedule has reached there.  Each number is the worse of the two.

After the window, with the program's state freed, the reference runs the
same steps from the same parameters and batches, and the one late step
from the copy.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from perfbench import faults, harness, roofline
from perfbench.reference import dense_lm
from perfbench.tracing import Trace

#: steps a traced run traces after its window
TRACE_STEPS = 3
FAULTS = faults.TRAIN_FAULTS
fault = faults.train_fault


def model_config(config: dict):
    """The program's configuration of the file's published sizes."""
    from repro_torch.configs.base import ModelConfig
    a = dense_lm.arch_of(config)
    return ModelConfig(
        name=config["name"], family="dense", n_layers=a["layers"],
        d_model=a["d"], n_heads=a["h"], n_kv_heads=a["kv"], d_ff=a["f"],
        vocab_size=a["vocab"], head_dim=a["hd"],
        qkv_bias=config["derived"]["qkv_bias"],
        tie_embeddings=config["tie_word_embeddings"],
        rope_theta=a["theta"], norm_eps=a["eps"])


def program_paths(a: dict) -> dict:
    """Each reference parameter's path in the program's tree."""
    out = {"embed": ("embed", "table"), "final_norm": ("final_norm", "scale")}
    for i in range(a["layers"]):
        blk = ("stack", i, "b0_attn")
        pre = f"layers.{i}."
        out[pre + "norm1"] = blk + ("norm1", "scale")
        out[pre + "norm2"] = blk + ("norm2", "scale")
        for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            out[pre + k] = blk + ("attn", k)
        for k in ("w_gate", "w_up", "w_down"):
            out[pre + k] = blk + ("mlp", k)
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def program_tree(lm, views: dict, paths: dict) -> dict:
    """The benchmark's parameters in the program's layout (the same
    tensors), checked leaf for leaf against the shapes the program's own
    init gives."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import LM
    meta = LM(lm.cfg, lm.mesh, device="meta")
    with torch.device("meta"):
        like = meta.init(torch.Generator())
    tree = tree_map(lambda x: x, like)
    for name, path in paths.items():
        *head, last = path
        node = get(tree, head)
        if not node[last].is_meta or \
                tuple(node[last].shape) != tuple(views[name].shape):
            raise ValueError(f"{name} -> {path}: {tuple(views[name].shape)}"
                             f" against the program's "
                             f"{tuple(node[last].shape)}")
        node[last] = views[name]
    if any(x.is_meta for x in tree_leaves(tree)):
        raise ValueError("the program's tree has leaves the benchmark "
                         "does not make")
    return tree


def make_batches(a: dict, traffic: dict, seed: int, device, n: int) -> list:
    """``n`` batches of ``(tokens, labels)``, (B, S) int64 each, the labels
    the next tokens; every row drawn from the seed."""
    b, s = traffic["batch"], traffic["seq_len"]
    gen = torch.Generator(device).manual_seed(seed ^ 0x5EED)
    ids = torch.randint(0, a["vocab"], (n, b, s + 1), generator=gen,
                        device=device)
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]


class Program:
    """The program's step and state, from the benchmark's parameters."""

    def __init__(self, ctx):
        from repro_torch.configs.base import ParallelConfig, TrainConfig
        from repro_torch.models.model import LM
        from repro_torch.optim import init_opt_state
        from repro_torch.runtime import train_lib

        cfg, traffic = ctx.cell.config, ctx.cell.traffic
        self.a = dense_lm.arch_of(cfg)
        opt = traffic["optimizer"]
        self.tcfg = TrainConfig(
            lr=opt["lr"], warmup_steps=opt["warmup_steps"],
            total_steps=opt["total_steps"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
            b1=opt["b1"], b2=opt["b2"])
        self.lm = LM(model_config(cfg), device=ctx.device)
        self.flat, self.views = dense_lm.make_params(self.a, ctx.seed,
                                                     ctx.device)
        self.paths = program_paths(self.a)
        self.params = program_tree(self.lm, self.views, self.paths)
        self.opt = init_opt_state(self.params, train_lib.make_adamw_config(
            self.lm.cfg, self.tcfg))
        self.step_fn = train_lib.make_train_step(
            self.lm, self.tcfg, ParallelConfig(remat=traffic["remat"]))

    def step(self, batch):
        tokens, labels = batch
        self.params, self.opt, metrics = self.step_fn(
            self.params, self.opt, {"tokens": tokens, "labels": labels})
        return metrics

    def leaf_norms(self, tree, scale: float = 1.0) -> dict:
        names = list(self.paths)
        norms = torch.stack([get(tree, self.paths[n]).float().norm()
                             for n in names]).tolist()
        return {n: v * scale for n, v in zip(names, norms)}


def check_steps(prog: Program, batches: list, b1: float) -> dict:
    """The program's first steps and what the reference checks of them."""
    p0 = {n: t.detach().clone() for n, t in prog.views.items()}
    losses, grad_norm = [], None
    for i, batch in enumerate(batches):
        losses.append(prog.step(batch)["loss"])
        if i == 0:
            grad_norm = prog.leaf_norms(prog.opt["m"], 1.0 / (1.0 - b1))
    change = torch.stack([(prog.views[n].detach() - p0[n]).norm()
                          for n in prog.paths]).tolist()
    return {"loss": [float(x) for x in losses], "grad_norm": grad_norm,
            "change_norm": dict(zip(prog.paths, change))}


def state_copy(prog: Program) -> dict:
    """A copy of the program's state by the reference's names: float32
    parameters and moments, and the steps it has made."""
    def leaf(tree, n):
        return get(tree, prog.paths[n]).detach().float().clone()
    return {"p": {n: leaf(prog.params, n) for n in prog.paths},
            "m": {n: leaf(prog.opt["m"], n) for n in prog.paths},
            "v": {n: leaf(prog.opt["v"], n) for n in prog.paths},
            "step": int(prog.opt["step"])}


def late_step(prog: Program, batch, b1: float) -> tuple[dict, dict]:
    """One more step of the program from the state the window left, and
    what the reference checks of it: the loss, each leaf's clipped
    gradient, worked out from the first moment before and after the step,
    and each leaf's change.  Returns the readings and the state copied
    before the step."""
    before = state_copy(prog)
    loss = prog.step(batch)["loss"]
    grad, change = {}, {}
    with torch.no_grad():
        for n, path in prog.paths.items():
            m = get(prog.opt["m"], path).float()
            grad[n] = float(((m - b1 * before["m"][n]) / (1.0 - b1)).norm())
            change[n] = float((get(prog.params, path).float()
                               - before["p"][n]).norm())
    return {"loss": [float(loss)], "grad_norm": grad,
            "change_norm": change}, before


def gaps(got: dict, want: dict, min_grad_share: float) -> dict:
    """The comparison's numbers: ``loss`` (the largest relative gap of a
    step's loss), ``grad_norm`` and ``change_norm`` (the worst leaf's gap
    between the program's norm and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf).  The change
    counts only leaves whose reference gradient is at least
    ``min_grad_share`` of the median leaf's (the others move under Adam by
    round-off alone).  A NaN anywhere, or no leaf to compare, reads
    ``inf``; where the reference moves nothing at all (a step at learning
    rate 0) a leaf's gap is 0 if the program's norm is the same, else
    ``inf``."""
    loss = harness.worst(abs(g - w) / abs(w) for g, w in zip(got["loss"],
                                                             want["loss"]))

    def gap(g, w, scale):
        if scale:
            return abs(g - w) / scale
        return 0.0 if g == w else math.inf

    def worst(key, names):
        if not names:
            return math.inf
        med = statistics.median(want[key][n] for n in names)
        return harness.worst(gap(got[key][n], want[key][n],
                                 max(want[key][n], med)) for n in names)

    names = list(want["grad_norm"])
    gmed = statistics.median(want["grad_norm"].values())
    moved = [n for n in names if want["grad_norm"][n] >= min_grad_share * gmed]
    return {"loss": loss, "grad_norm": worst("grad_norm", names),
            "change_norm": worst("change_norm", moved)}


def reference_readings(ctx, batches, fp8: bool = False) -> dict:
    a = dense_lm.arch_of(ctx.cell.config)
    return dense_lm.train_steps(a, ctx.seed, batches, ctx.cell.traffic,
                                ctx.device, fp8=fp8)


def control_checks(ctx) -> dict:
    """The comparison's numbers with the control (the reference with its
    products in float8) in the program's place, on the run's parameters
    and batches: its first steps from the seed's parameters, and one late
    step from the state that the float32 reference reaches after as many
    steps as the traffic has batches (a run's late step comes after its
    window); each number the worse of the two."""
    a = dense_lm.arch_of(ctx.cell.config)
    traffic = ctx.cell.traffic
    n = traffic["check_steps"] + traffic["window_batches"]
    batches = make_batches(a, traffic, ctx.seed, ctx.device, n)
    share = traffic["min_grad_share"]
    check = batches[:traffic["check_steps"]]
    first = gaps(reference_readings(ctx, check, fp8=True),
                 reference_readings(ctx, check), share)
    state = dense_lm.initial_state(a, ctx.seed, ctx.device)
    dense_lm.train_steps(a, ctx.seed, batches[:-1], traffic, ctx.device,
                         state=state)
    late = batches[-1:]
    got = dense_lm.train_steps(a, ctx.seed, late, traffic, ctx.device,
                               fp8=True, state=dense_lm.copy_state(state))
    want = dense_lm.train_steps(a, ctx.seed, late, traffic, ctx.device,
                                state=state)
    last = gaps(got, want, share)
    return {k: harness.worst([first[k], last[k]]) for k in first}


def _launches() -> int:
    from repro_torch.kernels import gemm as K
    return sum(K.LAUNCHES.values())


def run(ctx) -> dict:
    traffic = ctx.cell.traffic
    b1 = traffic["optimizer"]["b1"]
    from repro_torch.runtime import train_lib  # noqa: F401  (set-up)
    ctx.mark("imports")
    prog = Program(ctx)
    ctx.mark("program")
    n_check = traffic["check_steps"]
    batches = make_batches(prog.a, traffic, ctx.seed, ctx.device,
                           n_check + traffic["window_batches"])
    got = check_steps(prog, batches[:n_check], b1)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    harness.end_setup()
    ctx.mark("checked_steps")
    setup_s = time.perf_counter() - ctx.t_start
    pool = batches[n_check:]
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    steps = 0
    launches0 = _launches()
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("perfbench.step"):
            prog.step(pool[steps % len(pool)])
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches() - launches0
    tokens = traffic["batch"] * traffic["seq_len"]
    device = harness.device_info(ctx.device)
    e2e = {"train_tokens_per_s": steps * tokens / wall, "setup_s": setup_s}
    rec = {"kind": "train", "steps": steps, "wall_s": wall,
           "tokens_per_step": tokens, "launches_per_step": launches / steps,
           "gemm_products": roofline.train_gemm_products(ctx.cell.config,
                                                         tokens),
           "model_flops_per_step": roofline.train_model_flops(
               ctx.cell.config, traffic["batch"], traffic["seq_len"])}
    done = steps
    if ctx.trace:
        with Trace() as tr:
            for _ in range(TRACE_STEPS):
                with torch.profiler.record_function("perfbench.step"):
                    prog.step(pool[done % len(pool)])
                done += 1
            if cuda:
                torch.cuda.synchronize()
        red = tr.reduce()
        device["busy_s"], device["window_s"] = red["busy_s"], red["window_s"]
        rec["trace"] = red
        rec["traced_steps"] = TRACE_STEPS
        rec["breakdown"] = {"device_ops": red["device_ops"],
                            "idle_gaps": red["idle_gaps"]}
    late_batch = pool[done % len(pool)]
    late, state = late_step(prog, late_batch, b1)
    del prog, pool
    if cuda:
        torch.cuda.empty_cache()
    a = dense_lm.arch_of(ctx.cell.config)
    want_late = dense_lm.train_steps(a, ctx.seed, [late_batch], traffic,
                                     ctx.device, state=state)
    del state
    want = reference_readings(ctx, batches[:n_check])
    share = traffic["min_grad_share"]
    first, last = gaps(got, want, share), gaps(late, want_late, share)
    checks = {k: harness.worst([first[k], last[k]]) for k in first}
    failed = int(harness.over_limits(checks, ctx.cell.limits))
    return {"e2e": e2e, "rec": rec, "checks": checks, "attempted": steps,
            "failed": failed, "device": device}
