"""End-to-end training driver: the port of ``repro.launch.train``.

Wires together the model zoo (float32 masters), the token pipeline, the
AdamW train step, the SVC-maintained monitoring view (per-domain loss
with CIs between full maintenances), checkpoint/restart, and
straggler/failure monitoring with elastic re-planning.  On the card by
default; the CPU when asked:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 6 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt

The same flags as JAX's, plus ``--device`` (``cuda:N`` runs everything on
card N), and the same returned dict.
``--fail-at N`` simulates a host failure at step N: the monitor declares
it, the elastic planner shrinks the data axis, and training resumes from
the last committed checkpoint.  SVC runs at its cadences: ingest every
step, ``svc_refresh`` every ``--svc-every`` steps, ``mixture_weights``
every ``--mixture-every`` steps, ``full_maintenance`` at checkpoint
cadence.  Every family trains but encdec, whose batches need ``frames``
that the token pipeline does not make: JAX's launcher fails at its first
step, this one in ``build``, before it.  One difference from JAX,
deliberate: before restoring on a failure the loop waits for the async
checkpoint writer, so the newest save is the one restored (JAX reads
whatever the writer has committed).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, PipelineStats, TokenPipeline
from repro_torch.distributed.ft import FleetMonitor, plan_elastic_mesh
from repro_torch.launch.mesh import device_arg, on_device
from repro_torch.models import get_model
from repro_torch.training import AdamWConfig, init_train_state, make_train_step


def build(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        # JAX's launcher fails at its first step (its forward reads
        # batch["frames"]); this one fails before it, saying why
        raise ValueError(f"{cfg.name}: the encdec family trains on batches with 'frames' "
                         "(B, S_src, d_model); TokenPipeline's batches carry no frames "
                         "(train it through training.make_train_step)")
    model = get_model(cfg, device=args.device, train=True)
    pipe = TokenPipeline(
        PipelineConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                       seed=args.seed),
        device=args.device,
    )
    stats = PipelineStats(m=args.svc_ratio, seed=args.seed, device=args.device)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 5))
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    return cfg, model, pipe, stats, step_fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--svc-every", type=int, default=5, help="SVC refresh cadence")
    ap.add_argument("--svc-ratio", type=float, default=0.25)
    ap.add_argument("--mixture-every", type=int, default=25,
                    help="re-weight domains from SVC estimates")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a host failure at this step")
    ap.add_argument("--hosts", type=int, default=4, help="simulated fleet size")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", type=device_arg,
                    help="cpu, cuda (the current card) or cuda:N")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    with on_device(args.device):
        return _train(args)


def _train(args) -> dict:
    cfg, model, pipe, stats, step_fn = build(args)
    state = init_train_state(model, args.seed)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt, keep=3, async_write=True) if args.ckpt else None
    if ckpt and ckpt.list_steps():
        state, extra = ckpt.restore(state)
        start_step = int(extra.get("step", 0))
        print(f"[restore] resumed from step {start_step}")

    fleet = FleetMonitor(n_hosts=args.hosts, timeout_s=30.0)
    losses = []
    t_begin = time.time()
    i = start_step
    while i < args.steps:
        batch = pipe.batch(i)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        losses.append(loss)

        # fleet health (simulated heartbeats; per-host step times).  On the
        # injected failure step, time jumps past the heartbeat timeout: the
        # healthy hosts beat at the advanced clock, the failed host doesn't.
        now = time.time()
        jump = 31.0 if args.fail_at == i else 0.0
        for h in range(args.hosts):
            if args.fail_at is not None and i == args.fail_at and h == args.hosts - 1:
                continue  # host h stops heartbeating
            fleet.heartbeat(h, now + jump)
            fleet.report_step(h, dt)
        failed, stragglers = fleet.sweep(now + jump)
        if failed or stragglers:
            plan = plan_elastic_mesh(fleet.alive_hosts(), chips_per_host=4,
                                     model_parallel=1, target_data_parallel=args.hosts * 4)
            print(f"[elastic] lost hosts {failed + stragglers}; new plan: {plan}")
            if ckpt:
                ckpt.wait()
            if ckpt and ckpt.list_steps():
                state, extra = ckpt.restore(state)
                i = int(extra.get("step", i))
                print(f"[elastic] restored step {i}, continuing on shrunk fleet")

        # SVC monitoring: ingest per-domain loss deltas; refresh samples
        if "domain_loss_sum" in metrics:
            stats.ingest_step(metrics["domain_loss_sum"], metrics["domain_count"])
        if i > 0 and i % args.svc_every == 0:
            stats.svc_refresh()
        if i > 0 and i % args.mixture_every == 0:
            pipe.set_mixture(stats.mixture_weights())
        if i > 0 and args.ckpt and i % args.ckpt_every == 0:
            stats.full_maintenance()  # IVM at checkpoint cadence (§7.6.2)
            ckpt.save(i, state, extra={"step": i})
        if i % args.log_every == 0:
            est, (lo, hi) = stats.loss_estimate(0)
            print(f"step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms) "
                  f"dom0̂={est:.3f} [{lo:.3f},{hi:.3f}] alive={len(fleet.alive_hosts())}")
        i += 1

    if ckpt:
        ckpt.save(args.steps, state, extra={"step": args.steps})
        ckpt.wait()
    out = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "wall_s": time.time() - t_begin,
    }
    print(f"[done] {out}")
    return out


if __name__ == "__main__":
    main()
