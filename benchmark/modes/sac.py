"""Training: SAC's `train_iter`, as the training CLI builds the trainer.

The trainer comes from `space_gym_torch.train.make_trainer` with the mix's
flags (fused K-update, `--fused`), on the engine the configuration states.
The benchmark hands it the learner's first weights, drawn on the card from
the seed, through the trainer's public format bridge (`migrate_to_fused`),
and the lanes' reset uniforms; one `train_iter` (a captured rollout of the
actor on every lane, the replay insert, the warm-up gate, then one launch of
the fused K-update kernel K4) is one call of the window.

The check holds two stretches of the run to the references (the Goal env in
float64 under the actor in float32, and benchmark/reference/sac_update.py
with the products rounded to bfloat16 as the configuration states):

  the start  set-up drives the trainer through the window's own call until
             `checked_updates` calls have updated the learner, past the
             warm-up gate; the reference follows them from the first weights
             and the reset lanes with a ring of its own
  the end    after the window, one more call of the window's own on the
             state the window left (the ring full and wrapped, as the window
             ran); the reference follows it from the program's state at its
             start: leaves, Adam state, ring, lanes and generator state

The rollout's draws (a step's actor normals, then the engine's bulk
uniforms, inside the captured graph) are drawn again from the generator's
state at a call's start; the K-update's normals and sampled ring rows are
the program's own, recorded as it draws them (`Draws`).  The numbers:

  loss_gap        the widest relative gap of a start call's critic or actor loss
  grad_gap        after the first updating call, the widest gap between the
                  norms of a leaf's Adam first moment (its gradients as Adam
                  got them), over max(the leaf's norm, the median leaf's)
  change_gap      after the last, the same of a leaf's change from the start;
                  leaves whose reference moment is under a thousandth of the
                  median leaf's are left out (they move by rounding alone)
  end_*           the end call's, by `compare_last`
"""
from __future__ import annotations

import math
import statistics

import torch
from torch.overrides import TorchFunctionMode

from ..envcheck import LANE_TOL, GraphStep, lanes_of, lanes_off, program_config
from ..learnercheck import gap, leaf_gaps
from ..reference import sac_update as ref
from ..reference.goal_env import GoalEnv


class Mode:
    KERNEL = "sac_update_kernel"  # K4, the fused K-update kernel
    CALL_RANGE = "bench.train_iter"
    KERNEL_PER_CALL = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config = config
        self.t = traffic
        self.seed = seed
        self.device = device
        self.lanes = traffic["lanes"]
        self.steps = traffic["rollout_len"]
        self.done_sums = []

    # ------------------------------------------------------------- program --
    def _trainer(self):
        from space_gym_torch.train import make_trainer, parse_args

        t, env, eng = self.t, self.config["env"], self.config["engine"]
        program_config(env)
        argv = ["--env", env["env_id"], "--algo", "sac", "--fused",
                "--lanes", str(t["lanes"]), "--rollout-len", str(t["rollout_len"]),
                "--batch-size", str(t["batch_size"]),
                "--updates-per-iter", str(t["updates_per_iter"]),
                "--replay-rows", str(t["replay_rows"]), "--hidden", str(t["hidden"]),
                "--lr", str(t["lr"]), "--gamma", str(t["gamma"])]
        if self.device.type != "cuda":
            argv += ["--device", str(self.device)]
        tr = make_trainer(parse_args(argv))
        got = {"tau": tr.cfg.tau, "target_entropy": tr.target_entropy,
               "n_step": tr.cfg.n_step, "alpha_floor": tr.cfg.alpha_floor,
               "warmup_rows": tr.cfg.warmup_rows, "fused_block": tr.cfg.fused_block}
        for k, v in got.items():
            if t[k] != v:
                raise ValueError(f"the trainer has {k} {v}, the traffic {t[k]}")
        e = tr.engine
        got = {"tableau": e.tableau, "substeps": e.substeps, "refine_iters": e.refine_iters,
               "dtype": str(e.dtype).replace("torch.", ""),
               "uniforms": "bulk" if not e.in_kernel_rng else e.in_kernel_rng}
        for k, v in got.items():
            if eng[k] != v:
                raise ValueError(f"the trainer's engine has {k} {v}, the configuration {eng[k]}")
        return tr

    def first_params(self, gen: torch.Generator, od: int) -> ref.Params:
        """The learner's first weights, normal with variance 1 / fan-in, from
        one draw on the device; zero biases and padding rows; targets equal
        to the critics; log_alpha log(0.1)."""
        h = self.t["hidden"]
        shapes = [(od, h), (h, h), (h, 4), (2, od + 2, h), (2, h, h), (2, h)]
        fan = [od, h, h, od + 2, h, h]
        n = sum(math.prod(s) for s in shapes)
        z = torch.randn(n, generator=gen, device=self.device)
        parts, i = [], 0
        for s, f in zip(shapes, fan):
            k = math.prod(s)
            parts.append(z[i:i + k].reshape(s) / math.sqrt(f))
            i += k
        aw1, aw2, awh, cw1, cw2, cw3 = parts

        def zeros(*s):
            return torch.zeros(s, device=self.device)
        a_w1 = zeros(ref.IN1, h)
        a_w1[:od] = aw1
        c_w1 = zeros(2, ref.IN1, h)
        c_w1[:, :od + 2] = cw1
        critic = dict(w1=c_w1, b1=zeros(2, h), w2=cw2, b2=zeros(2, h), w3=cw3, b3=zeros(2))
        return ref.Params(
            a_w1=a_w1, a_b1=zeros(h), a_w2=aw2, a_b2=zeros(h), a_wh=awh, a_bh=zeros(4),
            **{f"c_{k}": v for k, v in critic.items()},
            **{f"t_{k}": v.clone() for k, v in critic.items()},
            log_alpha=torch.tensor(math.log(0.1), device=self.device))

    def setup(self):
        from space_gym_torch.models import fused_sac

        tr = self.trainer = self._trainer()
        self.fs = fused_sac.build(self.t["hidden"])
        od = tr.obs_dim
        gen = self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        params = self.first_params(gen, od)
        # the benchmark's weights into the trainer's fresh state, through its
        # public format bridge
        actor, critic, target, log_alpha = self.fs.unpack_params(
            self.fs.PackedParams(*[x.clone() for x in params]), od)
        st = tr.migrate_to_fused(tr.init(self.seed)._replace(
            actor_params=actor, critic_params=critic, target_critic_params=target,
            log_alpha=log_alpha))
        u = torch.rand((self.lanes, tr.engine.n_reset_rand), generator=gen, device=self.device)
        env_state, obs = tr.engine.reset(self.lanes, u=u)
        self.state = st._replace(env_state=env_state, obs=obs)
        idx = torch.arange(self.lanes, device=self.device)
        self.start = (params, lanes_of(env_state, idx, torch.float64), obs.clone())

        gate = self.gate = min(tr.cfg.warmup_rows, tr.cfg.replay_rows)
        self.obs_dim = od
        self.losses, self.moments, self.leaves = [], None, None
        self.first_calls = []  # per checked call: (generator state before it, its draws)
        while len(self.losses) < self.t["checked_updates"]:
            g0 = gen.get_state()
            with Draws(gen) as drawn:
                self.call()
            self.first_calls.append((g0, drawn))
            if len(self.first_calls) * self.steps >= gate:
                m = self.last_metrics
                self.losses.append((m["critic_loss"].clone(), m["actor_loss"].clone()))
                p, adam = self.fs.fused_unpack(self.state.fused)
                if self.moments is None:
                    self.moments = [x.clone() for x in adam.m]
                self.leaves = [x.clone() for x in p]
        for _ in range(self.t["warmup_calls"]):
            self.call()
        self.done_sums.clear()

    def call(self) -> int:
        """One train_iter; returns its env-steps.  No host sync."""
        self.state, self.last_metrics = self.trainer.train_iter(self.state, self.generator)
        self.done_sums.append(self.last_metrics["episodes_done"])
        return self.lanes * self.steps

    # ---------------------------------------------------------- yardstick --
    def iter_ops(self) -> dict:
        """{"bf16": n, "f32": n}: one train_iter's network arithmetic: the
        rollout's actor forwards and the K updates (roofline.sac_work)."""
        od, h = self.obs_dim, self.t["hidden"]
        _, ops = self.k4_work()
        fwd = 2 * self.lanes * self.steps * (od * h + h * h + h * 4)
        return {"bf16": ops["bf16"], "f32": ops["f32"] + fwd}

    def k4_work(self):
        """(bytes, ops) of one K4 launch, each sample's obs, next obs, action,
        reward and discount read once."""
        from ..roofline import sac_work

        t, od = self.t, self.obs_dim
        return sac_work(t["hidden"], t["updates_per_iter"], t["batch_size"], 2 * od + 4, od,
                        True, self.lanes)

    # ---------------------------------------------------------- the check --
    def products(self) -> str:
        """The precision of the program's products: bfloat16 on the card, as
        configured; its plain version on the CPU takes float32."""
        return "bf16" if self.device.type == "cuda" else "float32"

    def last_call(self) -> dict:
        """The window's end state, one more call of the window's own on it
        under `Draws`, and what that call changed; the program is released
        after."""
        from space_gym_torch.models.replay import replay_cols

        st = self.state
        p0, adam0 = self.fs.fused_unpack(st.fused)
        idx = torch.arange(self.lanes, device=self.device)
        before = dict(
            p=[x.clone() for x in p0], m=[x.clone() for x in adam0.m],
            v=[x.clone() for x in adam0.v], count=int(adam0.count),
            ring=st.replay.data.clone(), cursor=st.replay.cursor, filled=st.replay.filled,
            lanes=lanes_of(st.env_state, idx, torch.float64), obs=st.obs.clone(),
            gstate=self.generator.get_state(), cols=replay_cols(self.obs_dim, 2))
        with Draws(self.generator) as drawn:
            self.call()
        st, m = self.state, self.last_metrics
        p1, adam1 = self.fs.fused_unpack(st.fused)
        after = dict(
            p=[x.clone() for x in p1], m=[x.clone() for x in adam1.m],
            count=int(adam1.count), ring=st.replay.data,
            lanes=lanes_of(st.env_state, idx, torch.float64),
            obs=[r.double() for r in st.obs.t()],
            loss=(float(m["critic_loss"]), float(m["actor_loss"])))
        self.release()
        return {"before": before, "after": after, "drawn": drawn}

    def _rollout(self, env, p, lanes, obs, gen, step=None):
        """`steps` steps of the actor (float32) on the reference env from
        `lanes`, drawing a step's actor normals then its uniforms from `gen`;
        returns (lanes, obs, the steps' transitions, the step function)."""
        od = self.obs_dim
        rows = []
        for _ in range(self.steps):
            eps = torch.randn((self.lanes, 2), generator=gen, device=self.device)
            u = torch.rand((env.n_uniforms, self.lanes), generator=gen, device=self.device)
            o32 = obs.float()
            h1 = torch.relu(o32 @ p.a_w1[:od] + p.a_b1)
            head = torch.relu(h1 @ p.a_w2 + p.a_b2) @ p.a_wh + p.a_bh
            log_std = torch.clamp(head[:, 2:], ref.LOG_STD_MIN, ref.LOG_STD_MAX)
            action = torch.tanh(head[:, :2] + torch.exp(log_std) * eps)
            if step is None:
                step = (GraphStep(env, lanes, action, u) if self.device.type == "cuda"
                        else env.step)
            st = step(lanes, action, u)
            rows.append((o32, action, st.reward.float(), torch.stack(st.final_obs, 1).float(),
                         1.0 - st.terminated.float()))
            lanes, obs = st.lanes, torch.stack(st.obs, 1)
        return lanes, obs, rows, step

    def _update(self, p, m, v, count, ring, drawn, products):
        """The reference K-update on the ring rows and normals the program drew."""
        t = self.t
        rpb = t["batch_size"] // self.lanes
        noises, rows = drawn.update_draws()
        rows = rows.tolist()
        K = noises.shape[0]
        batch = ref.Batch(*[
            torch.stack([torch.cat([ring(r)[f] for r in rows[k * rpb:(k + 1) * rpb]])
                         for k in range(K)])
            for f in range(5)])
        return ref.update_k(p, m, v, count, batch, noises, obs_dim=self.obs_dim,
                            gamma=t["gamma"], tau=t["tau"], lr=t["lr"],
                            target_entropy=t["target_entropy"], products=products)

    def follow(self, products: str):
        """The reference over the checked calls of set-up, from the first
        weights and the reset lanes: (losses, moments after the first
        updating call, leaves after the last)."""
        params, lanes, obs = self.start
        env = GoalEnv(self.config, torch.float64)
        gen = torch.Generator(device=self.device)
        p = params
        m = v = ref.Params(*[torch.zeros_like(x) for x in p])
        count, losses, moments = 0, [], None
        ring, cursor, step = [None] * self.t["replay_rows"], 0, None
        for g0, drawn in self.first_calls:
            gen.set_state(g0)
            lanes, obs, rows, step = self._rollout(env, p, lanes, obs, gen, step)
            for r in rows:
                ring[cursor % len(ring)] = r
                cursor += 1
            if min(cursor, len(ring)) < self.gate:
                continue
            p, m, v, count, cl, al = self._update(p, m, v, count, ring.__getitem__, drawn,
                                                  products)
            losses.append((cl[-1], al[-1]))
            if moments is None:
                moments = list(m)
        return losses, moments, list(p)

    def follow_last(self, last: dict, products: str):
        """The reference over the window's end call, from the program's state
        at its start (its leaves, Adam state, ring, lanes and generator
        state): (losses, moments, leaves, lanes, obs, the rollout's rows)."""
        b = last["before"]
        o0, n0, a0, r0, d0, _ = b["cols"]
        od = self.obs_dim
        data = b["ring"]
        new = {}

        def ring(r):
            if r in new:
                return new[r]
            x = data[r].t()  # (lanes, W)
            return (x[:, o0:o0 + od], x[:, a0:a0 + 2], x[:, r0], x[:, n0:n0 + od], x[:, d0])

        env = GoalEnv(self.config, torch.float64)
        gen = torch.Generator(device=self.device)
        gen.set_state(b["gstate"])
        p = ref.Params(*b["p"])
        lanes, obs, rows, _ = self._rollout(env, p, b["lanes"], b["obs"].double(), gen)
        for i, r in enumerate(rows):
            new[(b["cursor"] + i) % data.shape[0]] = r
        if min(b["filled"] + self.steps, data.shape[0]) < self.gate:
            raise ValueError("the window ended before the warm-up gate")
        p, m, _, _, cl, al = self._update(p, ref.Params(*b["m"]), ref.Params(*b["v"]),
                                          b["count"], ring, last["drawn"], products)
        return (float(cl[-1]), float(al[-1])), list(m), list(p), lanes, obs, rows

    def check(self, control: bool = False) -> dict:
        """{name: value} of the numbers compared (module docstring).  With
        `control`, {"program": those, "control": the same numbers for the
        reference with float8 products in the program's place}."""
        start = list(self.start[0])
        got = (self.losses, self.moments, self.leaves)
        last = self.last_call()
        products = ["fp8"] if control else []
        out = []
        for prod in [self.products()] + products:
            want = self.follow(prod)
            want_last = self.follow_last(last, prod)
            if not out:
                out.append({**compare(start, got, want), **compare_last(last, want_last)})
                ref_start, ref_last = want, want_last
            else:  # the control in the program's place, against the reference
                ctrl_last = dict(last, after=dict(
                    last["after"], loss=want_last[0], m=want_last[1], p=want_last[2],
                    lanes=want_last[3], obs=list(want_last[4].t()),
                    ring=ring_of(last, want_last[5])))
                out.append({**compare(start, (want[0], want[1], want[2]), ref_start),
                            **compare_last(ctrl_last, ref_last)})
        if not control:
            return out[0]
        return {"program": out[0], "control": out[1]}

    def release(self):
        """Drop the program's state, trainer and captured graph."""
        self.state = self.trainer = self.last_metrics = None
        self.done_sums = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Draws(TorchFunctionMode):
    """Records what a call draws for the K-update from `generator`: its
    normals (a four-dimensional `torch.randn`) and its ring rows (a
    `torch.randint`), so that the reference takes the program's own."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator
        self.noises, self.rows = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if kwargs.get("generator") is self.generator:
            if func is torch.randint:
                self.rows.append(out.clone())
            elif func is torch.randn and out.dim() == 4:
                self.noises.append(out.clone())
        return out

    def update_draws(self):
        if len(self.noises) != 1 or len(self.rows) != 1:
            raise ValueError(f"an updating call drew {len(self.noises)} sets of normals and "
                             f"{len(self.rows)} of ring rows from its generator, not one each")
        return self.noises[0], self.rows[0]


ADAM_LEAVES = ref.ACTOR + ref.CRITIC + ("log_alpha",)
FIELDS = ref.Params._fields


def leaves(xs, keys=FIELDS):
    return {k: xs[FIELDS.index(k)] for k in keys}


def compare(start, got, want) -> dict:
    """The three numbers of `got` (losses, moments, leaves) against `want`,
    the reference's, from the first leaves `start`."""
    g_loss, g_m, g_p = got
    w_loss, w_m, w_p = want
    g_loss = [(float(c), float(a)) for c, a in g_loss]
    w_loss = [(float(c), float(a)) for c, a in w_loss]
    loss_gap = 0.0
    for j in (0, 1):  # critic, actor
        scale = statistics.mean(abs(w[j]) for w in w_loss)
        loss_gap = max([loss_gap] + [gap(g[j], w[j], scale) for g, w in zip(g_loss, w_loss)])
    grad_gap, change_gap = leaf_gaps(leaves(start), leaves(g_m, ADAM_LEAVES), leaves(g_p),
                                     leaves(w_m, ADAM_LEAVES), leaves(w_p))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def ring_of(last: dict, rows) -> torch.Tensor:
    """The ring before the end call with `rows` (the reference's
    transitions) written where the call writes, in the program's layout."""
    b = last["before"]
    o0, n0, a0, r0, d0, _ = b["cols"]
    od = b["obs"].shape[1]
    data = b["ring"].clone()
    for i, (o, a, r, n, d) in enumerate(rows):
        x = data[(b["cursor"] + i) % data.shape[0]]
        x[o0:o0 + od], x[a0:a0 + 2], x[r0], x[n0:n0 + od], x[d0] = o.t(), a.t(), r, n.t(), d
        x[d0 + 1] = 1.0  # the layout's row of ones
    return data


def compare_last(last: dict, want) -> dict:
    """The numbers of the window's end call against the reference's `want`
    (follow_last):

      end_lanes_off_pct  lanes whose state or observation after the rollout,
                         or a value of the ring's after the call, is off
      end_loss_gap       the call's last critic or actor loss
      end_change_gap     a leaf's change in the call, leaving out the leaves
                         whose reference moment gained in the call
                         (m - b1^K m0) is under a thousandth of the median

    The moments gained are not compared: they weigh the call's last steps
    most, where rounding alone parts the critics' gradients by a tenth or
    more (the reference in bfloat16 against itself in float32 reads so on
    the same state); the start's grad_gap holds the first gradient."""
    b, a = last["before"], last["after"]
    w_loss, w_m, w_p, w_lanes, w_obs, w_rows = want
    K = a["count"] - b["count"]
    off = lanes_off(a["lanes"], a["obs"], w_lanes, list(w_obs.t()))
    w_ring, g_ring = ring_of(last, w_rows), a["ring"]
    d = (g_ring.double() - w_ring.double()).abs()
    off |= (~(d <= LANE_TOL * torch.clamp(w_ring.double().abs(), min=1.0))).any(0).any(0)
    loss_gap = max(gap(g, w, abs(w)) for g, w in zip(a["loss"], w_loss))
    decay = ref.B1 ** K

    def gained(m):
        return [x - decay * x0 for x, x0 in zip(m, b["m"])]
    _, change_gap = leaf_gaps(leaves(b["p"]), leaves(gained(a["m"]), ADAM_LEAVES),
                              leaves(a["p"]), leaves(gained(w_m), ADAM_LEAVES), leaves(w_p))
    return {"end_lanes_off_pct": 100.0 * float(off.sum()) / off.numel(),
            "end_loss_gap": loss_gap, "end_change_gap": change_gap}
