"""Rebuild a resumable training checkpoint from a compact fused-SAC learner
file (docs/kepler_sac_learner_r2c.npz, or a `<ckpt>.best.npz` of
`python -m space_gym_torch.train`).

The port's counterpart of tools/restore_learner.py.  The npz holds the fused
kernel-layout learner (FusedState's fields, log_alpha, step); the env lanes
and the replay ring are made fresh, as the training run with the same flags
makes them, and the generators are seeded as it seeds them, so that
`python -m space_gym_torch.train ... --ckpt OUT --resume --fused` continues
from the learner.

With --obs-features the target run appends analytic observation features
(engine/core.py `obs_features`), so its obs_dim is wider than the saved
learner's.  The learner is then migrated without changing what it computes:
the new feature columns enter through ZERO first-layer weight rows (the
actor's after its obs rows; the critics' between the obs rows and the
action rows, which move up), in the parameters and in Adam's moments.

    python -m space_gym_torch.restore_learner --npz docs/kepler_sac_learner_r2c.npz \
        --env KeplerCircleOrbit-v0 --out kepler.pt --obs-features kepler --from-obs-dim 10
    python -m space_gym_torch.train --env KeplerCircleOrbit-v0 --algo sac --fused \
        --obs-features kepler --ckpt kepler.pt --resume ...
"""
from __future__ import annotations

import argparse

import torch


def expand_first_layer(params: dict, old_d: int, new_d: int, has_action: bool) -> dict:
    """Zero-pad the first-layer kernels (`*.layers.0.kernel`, (in, out)) of a
    parameter dict from old_d to new_d obs rows.  An actor's input is [obs];
    a critic's is [obs | action], so its action rows move from old_d: to
    new_d: with zeros in between.

    Raises if no first-layer kernel has old_d (or old_d + 2) rows: a wrong
    --from-obs-dim, or migrating a learner twice, would otherwise change
    nothing and still report success."""
    grow = new_d - old_d
    out, n_expanded = dict(params), 0
    for name, leaf in params.items():
        if not name.endswith(".layers.0.kernel") or leaf.dim() != 2:
            continue
        zeros = torch.zeros((grow, leaf.shape[1]), dtype=leaf.dtype, device=leaf.device)
        if leaf.shape[0] == old_d and not has_action:
            out[name] = torch.cat([leaf, zeros])
            n_expanded += 1
        elif leaf.shape[0] == old_d + 2 and has_action:
            out[name] = torch.cat([leaf[:old_d], zeros, leaf[old_d:]])
            n_expanded += 1
    if n_expanded == 0:
        raise SystemExit(
            f"expand_first_layer: no first-layer kernel has {old_d} (or {old_d + 2}) input "
            "rows — wrong --from-obs-dim, or the learner was already migrated")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz", required=True)
    ap.add_argument("--env", default="KeplerCircleOrbit-v0")
    ap.add_argument("--out", required=True, help="checkpoint file to write")
    ap.add_argument("--obs-features", default=None, choices=["kepler", "goal", "dnc"],
                    help="the target run's obs featurization (its --obs-features)")
    ap.add_argument("--from-obs-dim", type=int, default=None,
                    help="obs_dim the npz learner was trained with; when it differs from the "
                         "target engine's the learner is migrated through zero first-layer rows")
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--rollout-len", type=int, default=8)
    ap.add_argument("--updates-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--replay-rows", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, 'cpu' for the plain twins")
    return ap.parse_args(argv)


def migrate(layout, fused, old_d: int, new_d: int):
    """A fused learner at obs_dim old_d as one at new_d: unpacked at old_d,
    the first-layer kernels of the parameters and both Adam moments
    zero-expanded, packed again."""
    packed, adam = layout.fused_unpack(fused)

    def expand(p):
        actor, critic, target, log_alpha = layout.unpack_params(p, old_d, 2)
        return layout.pack_params(expand_first_layer(actor, old_d, new_d, has_action=False),
                                  expand_first_layer(critic, old_d, new_d, has_action=True),
                                  expand_first_layer(target, old_d, new_d, has_action=True),
                                  log_alpha)

    return layout.fused_init(expand(packed), layout.PackedAdam(
        m=expand(adam.m), v=expand(adam.v), count=adam.count))


def main(argv=None):
    args = parse_args(argv)
    from . import train
    from .models import convert
    from .utils import checkpoint as ckpt

    fused, _, meta = convert.load_learner_npz(args.npz)  # on the CPU
    if meta["kind"] != "sac":
        raise SystemExit(f"{args.npz} holds a {meta['kind']} learner, not a fused SAC one")
    targs = train.parse_args([
        "--env", args.env, "--algo", "sac", "--fused", "--lanes", str(args.lanes),
        "--rollout-len", str(args.rollout_len), "--updates-per-iter", str(args.updates_per_iter),
        "--batch-size", str(args.batch_size), "--replay-rows", str(args.replay_rows),
        "--hidden", str(fused.w.shape[1]), "--seed", str(args.seed)]
        + (["--obs-features", args.obs_features] if args.obs_features else [])
        + (["--device", args.device] if args.device else []))
    tr = train.make_trainer(targs)
    state = tr.init(args.seed)
    fused = type(fused)(*[x.to(tr.device) if isinstance(x, torch.Tensor) else x for x in fused])

    # Newer npzs record their training obs_dim and obs_features (train.py's
    # best-learner file); trust them over the flags, so that a wrong or
    # missing --from-obs-dim cannot mis-slice the packed learner.
    if "obs_dim" in meta:
        old_d = int(meta["obs_dim"])
        if args.from_obs_dim is not None and args.from_obs_dim != old_d:
            raise SystemExit(f"--from-obs-dim {args.from_obs_dim} contradicts the npz's "
                             f"recorded obs_dim {old_d}")
    else:
        old_d = args.from_obs_dim or tr.obs_dim
    if "obs_features" in meta:
        npz_feats = str(meta["obs_features"]) or None
        if npz_feats != args.obs_features and old_d == tr.obs_dim:
            raise SystemExit(
                f"npz was trained with obs_features={npz_feats!r} but the target engine uses "
                f"{args.obs_features!r} (same obs_dim — the learner would read the wrong "
                "columns)")
    if old_d != tr.obs_dim:
        fused = migrate(tr._fs, fused, old_d, tr.obs_dim)
        print(f"expanded learner obs_dim {old_d} -> {tr.obs_dim} (zero rows for the new "
              "feature columns)")

    step = int(meta.get("step", 0))
    state = tr._refresh_from_fused(state._replace(fused=fused, step=step))
    gen, eval_gen = tr.generator(args.seed + 1), tr.generator(args.seed + 2)
    ckpt.save(args.out, {"state": state, "generator": gen.get_state(),
                         "eval_generator": eval_gen.get_state()})
    print(f"wrote {args.out}: step {step}, fused count {fused.count} (replay and env state "
          "fresh)")
    return state


if __name__ == "__main__":
    main()
