"""The counterpart of the reference's root entry module (``__graft_entry__.py``):
a forward step on the flagship model, and the multichip dry run.

``entry()`` returns the batched MLP's forward and example arguments.

``dryrun_multichip(n)`` runs the dry run's stages in a child process
(``python -m hpbandster_tpu_torch.entry --dryrun-child <n> --device <dev>``)
on a ``("config", "model")`` mesh of ``n`` positions that repeat one
device: the tensor-parallel batched MLP step (``parallel/tensor_parallel.py``,
the hidden dims split over ``model``, held to the unsplit step), the fused
bracket, the fused whole sweep, a conditional space, a chunked checkpoint
resumed into a fresh meshed optimizer (equal to the uninterrupted run bit
for bit), the sequence-parallel ring, and one sweep over two processes of
a gloo group that must reach bit-identical promotions. Every stage prints
one ``dryrun:`` line; a failed stage fails the child, and the child's
failure raises in the parent.

Run as a module it is the reference's self-test: the entry forward, then
``dryrun_multichip(8)``, on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.parallel.mesh import Mesh, config_mesh, config_model_mesh
from hpbandster_tpu_torch.parallel.tensor_parallel import (
    gather_mlp_params,
    sgd_train_step_batch_tp,
    shard_mlp_params,
)
from hpbandster_tpu_torch.workloads.mlp import (
    MLPConfig,
    draw_mlp_unit_params,
    init_mlp_params,
    mlp_forward,
    sgd_train_step_batch,
)
from hpbandster_tpu_torch.workloads.train import make_generator

__all__ = [
    "entry",
    "dryrun_multichip",
    "dryrun_mesh",
    "tensor_parallel_stage",
    "meshed_checkpoint_round_trip",
    "run_dryrun",
]

#: the package's parent: the child processes find the package there
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the split step against the unsplit one (float32, TF32 off): the
#: row-parallel sum reorders additions
TP_RTOL = 1e-5
TP_ATOL = 1e-6
#: the ring's logits against the dense forward's (the reference's bound)
RING_TOL = 5e-2
#: the whole child's run, and one rank's
CHILD_TIMEOUT_S = 1800
RANK_TIMEOUT_S = 600


def entry(device=None):
    """``(mlp_forward, (params, x))`` at ``MLPConfig(d_in=16, width=64,
    n_classes=8)`` with one lane of seeded unit-scale weights and ``x`` of
    ones ``[32, 16]``, on ``device`` (``None`` means CUDA and raises
    without it). The port's forward is lane-stacked, so its logits are
    ``[1, 32, 8]`` where the reference's are ``[32, 8]``."""
    dev = resolve_device(device)
    cfg = MLPConfig(d_in=16, width=64, n_classes=8)
    unit = draw_mlp_unit_params(make_generator(dev, 0), cfg)
    params = init_mlp_params(unit, torch.ones(1, device=dev))
    x = torch.ones((32, cfg.d_in), device=dev)
    return mlp_forward, (params, x)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The dry run in a child process on ``n_devices`` positions of
    ``device`` (``None`` means CUDA and raises without it). Forwards the
    child's stdout; a non-zero exit raises ``RuntimeError`` with the exit
    code and both streams. The child gets the device as an argument and
    the package on its path; the parent joins no process group and touches
    no card state of the child's."""
    dev = resolve_device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "hpbandster_tpu_torch.entry", "--dryrun-child",
         str(int(n_devices)), "--device", str(dev)],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip child failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
        )
    print(proc.stdout, end="")


def dryrun_mesh(n_devices: int, device) -> Mesh:
    """The dry run's ``("config", "model")`` mesh: ``(n // 2, 2)`` for an
    even ``n``, ``(n, 1)`` otherwise, every position on ``device``."""
    model_par = 2 if n_devices % 2 == 0 else 1
    return config_model_mesh(n_devices // model_par, [device] * n_devices)


def _lane_mlp_params(cfg: MLPConfig, n: int, device) -> Dict[str, torch.Tensor]:
    """``n`` lanes of unit-scale MLP weights, each lane its own draw from
    one generator seeded with 0 (the reference vmaps its initialiser over
    split keys of ``key(0)``)."""
    gen = make_generator(torch.device(device), 0)
    lanes = [draw_mlp_unit_params(gen, cfg) for _ in range(n)]
    return {k: torch.stack([lane[k] for lane in lanes]) for k in lanes[0]}


def _max_err(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """The largest ``|got - want|`` and whether every element lies within
    ``atol + rtol * |want|``."""
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def tensor_parallel_stage(mesh: Mesh, cfg: MLPConfig, n_configs: int, device) -> dict:
    """One split momentum-SGD step (lr 0.1, momentum 0.9, weight decay
    1e-4 on ``x`` of ones and labels 0, as the reference's dry run) held
    to the unsplit step within ``TP_RTOL`` / ``TP_ATOL``: the losses'
    shape and finiteness, a non-zero update of ``w1``, and every leaf of
    the new parameters and velocity. Returns the step's facts."""
    dev = torch.device(device)
    params = _lane_mlp_params(cfg, n_configs, dev)
    velocity = {k: torch.zeros_like(v) for k, v in params.items()}
    x = torch.ones((cfg.batch_size, cfg.d_in), device=dev)
    y = torch.zeros((cfg.batch_size,), dtype=torch.int64, device=dev)
    lrs = torch.full((n_configs,), 0.1, device=dev)
    momenta = torch.full((n_configs,), 0.9, device=dev)
    wds = torch.full((n_configs,), 1e-4, device=dev)
    new_p, new_v, losses = sgd_train_step_batch_tp(
        shard_mlp_params(params, mesh), shard_mlp_params(velocity, mesh), x, y, lrs,
        momenta, wds, mesh)
    got_p, got_v = gather_mlp_params(new_p, mesh), gather_mlp_params(new_v, mesh)
    if tuple(losses.shape) != (n_configs,):
        raise AssertionError(f"losses of shape {tuple(losses.shape)}, want ({n_configs},)")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite losses: {losses.tolist()}")
    delta = float((got_p["w1"] - params["w1"].to(got_p["w1"].device)).abs().max())
    if not delta > 0.0:
        raise AssertionError("the split training step was a no-op")
    want_p, want_v, want_l = sgd_train_step_batch(params, velocity, x, y, lrs, momenta, wds)
    worst = 0.0
    for name, got, want in ([(f"params.{k}", got_p[k], want_p[k]) for k in want_p]
                            + [(f"velocity.{k}", got_v[k], want_v[k]) for k in want_v]
                            + [("losses", losses, want_l)]):
        err, ok = _max_err(got, want.to(got.device), TP_RTOL, TP_ATOL)
        if not ok:
            raise AssertionError(f"split step's {name} off the unsplit step by {err}")
        worst = max(worst, err)
    return {"n_configs": n_configs, "model_par": mesh.shape["model"],
            "max_dw1": delta, "max_abs_err_vs_unsplit": worst}


def _toy_eval(vectors: torch.Tensor, budget: float) -> torch.Tensor:
    return torch.sum(torch.square(vectors - 0.5), dim=-1) / math.sqrt(budget)


def _runs(res) -> List[tuple]:
    return sorted((tuple(r.config_id), float(r.budget), float(r.loss))
                  for r in res.get_all_runs() if r.loss is not None)


def _cond_space(seed: int, parent: str, choices, child: str, child_upper: float):
    """The reference's conditional Branin space: ``x``, ``y``, a
    categorical ``parent`` and a float ``child`` in ``[0, child_upper]``,
    active only where ``parent`` takes its first choice."""
    from hpbandster_tpu_torch.space import (
        CategoricalHyperparameter,
        ConfigurationSpace,
        EqualsCondition,
        UniformFloatHyperparameter,
    )

    cs = ConfigurationSpace(seed=seed)
    choice = CategoricalHyperparameter(parent, list(choices))
    extra = UniformFloatHyperparameter(child, 0.0, child_upper)
    cs.add_hyperparameters([UniformFloatHyperparameter("x", -5.0, 10.0),
                            UniformFloatHyperparameter("y", 0.0, 15.0), choice, extra])
    cs.add_condition(EqualsCondition(extra, choice, choices[0]))
    return cs


def meshed_checkpoint_round_trip(mesh: Mesh) -> int:
    """A chunked meshed ``FusedBOHB`` on Branin (seed 5, chunks of 2
    brackets) stopped after 2 of 4 brackets, a chunk boundary, with a
    checkpoint, restored into a fresh meshed optimizer and finished,
    against the uninterrupted run: their runs must be equal bit for bit.
    Returns the number of runs."""
    from hpbandster_tpu_torch.optimizers import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    def make():
        return FusedBOHB(configspace=branin_space(seed=5), eval_fn=branin,
                         run_id="dryrun-ckpt", min_budget=1, max_budget=9, eta=3,
                         seed=5, mesh=mesh, min_points_in_model=5)

    want = _runs(make().run(n_iterations=4, chunk_brackets=2))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fused.pkl")
        make().run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)
        resumed = make()
        resumed.load_checkpoint(path)
        got = _runs(resumed.run(n_iterations=4, chunk_brackets=2))
    if got != want:
        raise AssertionError("mesh resume diverged from the uninterrupted run")
    return len(got)


def _stage_fused_bracket(mesh: Mesh, n_devices: int) -> int:
    from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn

    n0 = max(2 * n_devices + 1, 9)  # deliberately not mesh-divisible
    vecs = torch.rand((n0, 4), generator=torch.Generator().manual_seed(1)).numpy()
    stages = make_fused_bracket_fn(_toy_eval, (n0, max(n0 // 3, 1), 1), (1.0, 3.0, 9.0),
                                   mesh=mesh)(vecs)
    final_idx, final_losses = stages[-1]
    if np.asarray(final_idx).shape != (1,) or not np.isfinite(final_losses).all():
        raise AssertionError(f"fused bracket's last stage: {final_idx}, {final_losses}")
    return n0


def _stage_fused_sweep(mesh: Mesh) -> int:
    from hpbandster_tpu_torch.optimizers import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    res = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin, run_id="dryrun",
                    min_budget=1, max_budget=9, eta=3, seed=0, mesh=mesh).run(n_iterations=2)
    runs = res.get_all_runs()
    if not runs or not all(np.isfinite(r.loss) for r in runs if r.loss is not None):
        raise AssertionError("fused whole sweep: no runs or non-finite losses")
    return len(runs)


def _cond_eval(vectors: torch.Tensor, budget: float) -> torch.Tensor:
    from hpbandster_tpu_torch.workloads.toys import branin

    return branin(vectors[:, :2], budget) + 0.1 * vectors[:, 3]


def _stage_conditional(mesh: Mesh) -> int:
    from hpbandster_tpu_torch.optimizers import FusedBOHB

    cs = _cond_space(0, "opt", ("sgd", "adam"), "momentum", 0.99)
    res = FusedBOHB(configspace=cs, eval_fn=_cond_eval, run_id="dryrun-cond", min_budget=1,
                    max_budget=9, eta=3, seed=3, mesh=mesh,
                    min_points_in_model=6).run(n_iterations=3)
    id2c = res.get_id2config_mapping()
    if not id2c:
        raise AssertionError("conditional sweep: no configurations")
    for entry_ in id2c.values():
        cfg = entry_["config"]
        if ("momentum" in cfg) != (cfg["opt"] == "sgd"):
            raise AssertionError(f"conditional sweep: activity pattern broken in {cfg}")
    return len(res.get_all_runs())


def _stage_ring(n_devices: int, device) -> float:
    from hpbandster_tpu_torch.ops.ring_attention import seq_mesh
    from hpbandster_tpu_torch.workloads import transformer as tfm

    dev = torch.device(device)
    cfg = tfm.TransformerConfig(vocab=16, prefix_len=n_devices, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, n_train=8, n_val=4, batch_size=4)
    unit = tfm.draw_transformer_unit_params(make_generator(dev, 7), cfg)
    params = tfm.init_transformer_params(unit, torch.ones(1, device=dev))
    (x, _), _, _ = tfm.make_copy_dataset(make_generator(dev, 8), cfg)
    tokens = x[:1]  # one sequence of 2 n tokens: a 2-token block per shard
    with torch.no_grad():
        ring = tfm.transformer_forward_seq_parallel(params, tokens, cfg,
                                                    seq_mesh([dev] * n_devices))
        local = tfm.transformer_forward(params, tokens, cfg)
    err = float((ring.float() - local.float()).abs().max())
    if not err < RING_TOL:
        raise AssertionError(f"ring attention diverged: max|d|={err}")
    return err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stage_two_ranks(device) -> int:
    """Two rank processes of a gloo group, each with two positions of
    ``device``, run the same sweep on the 4-position config mesh; their
    promotions must be bit-identical. Returns the number of runs."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hpbandster_tpu_torch.entry", "--dcn-rank", coordinator,
             str(rank), outdir, "--device", str(device)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=30)
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} failed (rc={p.returncode}):\n{out}")
        dumps = []
        for rank in range(2):
            with open(os.path.join(outdir, f"fused_runs_{rank}.json")) as f:
                dumps.append(json.load(f))
    if not dumps[0] or dumps[0] != dumps[1]:
        raise AssertionError("the two ranks' fused promotions diverged")
    return len(dumps[0])


def _rank_main(coordinator: str, rank: int, outdir: str, device) -> None:
    """One rank of the dry run's two-process stage: join the gloo group,
    build the config mesh of two local positions per rank over it, and run
    the reference's deterministic conditional sweep (static, warm static,
    chunked), writing the runs."""
    import torch.distributed as dist

    from hpbandster_tpu_torch.optimizers import FusedBOHB
    from hpbandster_tpu_torch.parallel.mesh import is_multiprocess_mesh
    from hpbandster_tpu_torch.parallel.multihost import initialize_multihost
    from hpbandster_tpu_torch.workloads.toys import branin

    dev = resolve_device(device)
    got = initialize_multihost(coordinator, 2, rank, backend="gloo", timeout_s=120)
    if got != rank:
        raise AssertionError(f"joined as rank {got}, not {rank}")
    try:
        mesh = config_mesh([dev] * 2, process_group=dist.group.WORLD)
        if mesh.shape != {"config": 4} or not is_multiprocess_mesh(mesh):
            raise AssertionError(f"unexpected mesh {mesh!r}")
        cs = _cond_space(1, "arm", ("a", "b"), "extra", 1.0)

        def cond_eval(v, budget):
            return branin(v[:, :2], budget) + 0.05 * v[:, 3]

        opt = FusedBOHB(configspace=cs, eval_fn=cond_eval, run_id="dryrun-dcn", min_budget=1,
                        max_budget=9, eta=3, seed=1, mesh=mesh, min_points_in_model=5)
        opt.run(n_iterations=1)
        opt.run(n_iterations=2)
        res = opt.run(n_iterations=3, chunk_brackets=1)
        if opt.run_stats[1]["dynamic_counts"] or not opt.run_stats[-1]["dynamic_counts"]:
            raise AssertionError("the warm continuation left the static tier, or the "
                                 "chunked one did not take the dynamic tier")
        for entry_ in res.get_id2config_mapping().values():
            cfg = entry_["config"]
            if ("extra" in cfg) != (cfg["arm"] == "a"):
                raise AssertionError(f"activity pattern broken in {cfg}")
        with open(os.path.join(outdir, f"fused_runs_{rank}.json"), "w") as f:
            json.dump([list(r) for r in _runs(res)], f)
        print(f"rank {rank}: OK", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_dryrun(n_devices: int, device=None) -> dict:
    """The dry run's body in this process on ``n_devices`` positions of
    ``device`` (``None`` means CUDA and raises without it): every stage in
    the reference's order, one ``dryrun:`` line each. Returns each stage's
    facts."""
    from hpbandster_tpu_torch.parallel.mesh import _normalize

    dev = _normalize(resolve_device(device))
    mesh = dryrun_mesh(n_devices, dev)
    config_par, model_par = mesh.shape["config"], mesh.shape["model"]
    print(f"dryrun: {n_devices} positions of {dev}, mesh ('config', 'model') = "
          f"({config_par}, {model_par})", flush=True)
    out = {}
    # (a) the tensor-parallel step at the reference's tiny shapes
    cfg = MLPConfig(d_in=8, width=4 * model_par, n_classes=4, batch_size=16)
    tp = out["tensor_parallel"] = tensor_parallel_stage(mesh, cfg, 2 * config_par, dev)
    print(f"dryrun: tensor-parallel train step OK ({tp['n_configs']} configs "
          f"tp={model_par}, max|dw1|={tp['max_dw1']:.2e}, max|d unsplit|="
          f"{tp['max_abs_err_vs_unsplit']:.1e})", flush=True)
    n0 = out["fused_bracket"] = _stage_fused_bracket(mesh, n_devices)
    print(f"dryrun: fused bracket OK ({n0} configs, 3 stages, non-divisible pad)",
          flush=True)
    n = out["fused_sweep"] = _stage_fused_sweep(mesh)
    print(f"dryrun: fused whole-sweep OK ({n} runs, 2 brackets)", flush=True)
    n = out["conditional"] = _stage_conditional(mesh)
    print(f"dryrun: fused conditional-space sweep OK ({n} runs, activity pattern "
          f"verified)", flush=True)
    # (b) the checkpoint across the mesh
    n = out["checkpoint"] = meshed_checkpoint_round_trip(mesh)
    print(f"dryrun: fused mesh checkpoint/resume OK ({n} runs, resume == "
          f"uninterrupted bitwise)", flush=True)
    # (c) the sequence-parallel ring
    err = out["ring"] = _stage_ring(n_devices, dev)
    print(f"dryrun: seq-parallel ring attention OK ({n_devices}-shard ring, "
          f"T={2 * n_devices}, max|d logits|={err:.1e})", flush=True)
    # (d) two processes of a gloo group
    n = out["two_ranks"] = _stage_two_ranks(dev)
    print(f"dryrun: fused 2-process gloo sweep OK ({n} runs, promotions "
          f"bit-identical across ranks)", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda; 'cpu' for the plain path)")
    parser.add_argument("--dryrun-child", type=int, metavar="N",
                        help="run the dry run's body on N positions in this process")
    parser.add_argument("--dcn-rank", nargs=3, metavar=("COORDINATOR", "RANK", "OUTDIR"),
                        help="run one rank of the dry run's two-process stage")
    args = parser.parse_args(argv)
    if args.dcn_rank is not None:
        coordinator, rank, outdir = args.dcn_rank
        _rank_main(coordinator, int(rank), outdir, args.device)
        return 0
    if args.dryrun_child is not None:
        run_dryrun(args.dryrun_child, args.device)
        print("dryrun child: OK", flush=True)
        return 0
    fn, fn_args = entry(args.device)
    with torch.no_grad():
        print("entry forward:", tuple(fn(*fn_args).shape), flush=True)
    dryrun_multichip(8, args.device)
    print("dryrun_multichip(8): OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
