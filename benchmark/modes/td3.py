"""Training: TD3's `train_iter`, as the training CLI builds the trainer.

The trainer comes from `space_gym_torch.train.make_trainer` with `--algo td3
--fused` and the mix's flags, on the engine the configuration states; every
value of its configuration and engine is held to the mix's and the
configuration's, and its networks to the configuration's `learner` (TD3's
deterministic actor, the widths, the observation and action sizes and the
number of critics).  The benchmark hands it the learner's first weights, drawn
on the card from the seed, through the trainer's public format bridge
(`migrate_to_fused`), and the lanes' reset uniforms; one `train_iter` (a
captured rollout of the deterministic actor with Gaussian exploration on
every lane, the replay insert, the warm-up gate, then one launch of the fused
TD3 K-update kernel K6) is one call of the window.

The check is modes/sac.py's, on TD3's learner (the Goal env in float64 under
the actor in float32, and benchmark/reference/td3_update.py with the products
rounded as the mix states):

  the start  set-up drives the trainer through the window's own call until
             `checked_updates` calls have updated the learner, past the
             warm-up gate; the reference follows them from the first weights
             and the reset lanes with a ring of its own
  the end    after the window, one more call of the window's own on the
             state the window left (the ring full and wrapped); the
             reference follows it from the program's state at its start:
             leaves, Adam state and both Adam counts, ring, lanes and
             generator state

The rollout's draws (a step's exploration normals, then the engine's bulk
uniforms, inside the captured graph) are drawn again from the generator's
state at a call's start; the K-update's smoothing normals and sampled ring
rows are the program's own, recorded as it draws them (`Draws`).  The
numbers, as modes/sac.py defines them:

  loss_gap, grad_gap, change_gap, end_lanes_off_pct, end_loss_gap,
  end_change_gap; an actor loss's gap is over the mean |Q1| of its batch
  (the loss is -mean Q1, which passes near zero where those values do not),
  and the actor's moments decay over its own delayed steps
  update_counts_off  over every call of the run, the program's count of
                     critic and of actor updates (`td3.critic_updates`,
                     `td3.actor_updates`) off the benchmark's own, from the
                     mix's K and `policy_delay`; left out where the program
                     counts neither
"""
from __future__ import annotations

import gc
import math
import statistics

import torch
from torch.overrides import TorchFunctionMode

from ..envcheck import LANE_TOL, GraphStep, lanes_of, lanes_off, program_config
from ..learnercheck import gap, leaf_gaps
from ..reference import td3_update as ref
from ..reference.goal_env import GoalEnv
from ..reference.sac_update import B1
from .sac import ring_of

# the trainer's configuration fields, each held to the mix's value of that name
CONFIG_KEYS = ("lanes", "rollout_len", "replay_rows", "batch_size", "updates_per_iter",
               "gamma", "tau", "lr", "explore_std", "smooth_std", "smooth_clip",
               "policy_delay", "warmup_rows", "fused_block")


def delayed_updates(first: int, k: int, delay: int) -> int:
    """How many of the updates numbered first .. first + k - 1 move the actor:
    those whose number is a multiple of `delay`."""
    return (first + k - 1) // delay - (first - 1) // delay


def counts_off(before, counted, calls_live, k: int, delay: int):
    """update_counts_off: `before` the program's (critic, actor) counts before
    the first call, `counted` its counts after each call, `calls_live`
    whether each call passed the warm-up gate; a count not yet kept reads 0.
    None where the program kept neither count by the last call (it counts
    no updates)."""
    if not counted or counted[-1] == (None, None):
        return None
    off, n, prev = 0, 0, before
    for c, live in zip(counted, calls_live):
        want = (k, delayed_updates(n, k, delay)) if live else (0, 0)
        n += want[0]
        off += sum(abs((x or 0) - (x0 or 0) - w) for x, x0, w in zip(c, prev, want))
        prev = c
    return off


def program_counts() -> tuple:
    """The program's (critic, actor) update counts, each None where it keeps
    none (yet)."""
    try:
        from space_gym_torch.utils.profiling import counts
    except ImportError:
        return None, None
    c = counts()
    return c.get("td3.critic_updates"), c.get("td3.actor_updates")


class Mode:
    KERNEL = "td3_update_kernel"  # K6, the fused TD3 K-update kernel
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
        self.counted = []  # the program's counts after each call

    # ------------------------------------------------------------- program --
    def _trainer(self):
        from space_gym_torch.train import make_trainer, parse_args

        t, env, eng = self.t, self.config["env"], self.config["engine"]
        program_config(env)
        argv = ["--env", env["env_id"], "--algo", "td3", "--fused",
                "--lanes", str(t["lanes"]), "--rollout-len", str(t["rollout_len"]),
                "--batch-size", str(t["batch_size"]),
                "--updates-per-iter", str(t["updates_per_iter"]),
                "--replay-rows", str(t["replay_rows"]), "--hidden", str(t["hidden"]),
                "--lr", str(t["lr"]), "--gamma", str(t["gamma"])]
        if self.device.type != "cuda":
            argv += ["--device", str(self.device)]
        tr = make_trainer(parse_args(argv))
        c = tr.cfg
        got = {k: getattr(c, k) for k in CONFIG_KEYS}
        got.update(hidden=c.hidden[0] if c.hidden == (c.hidden[0],) * 2 else c.hidden)
        for k, v in got.items():
            if t[k] != v:
                raise ValueError(f"the trainer has {k} {v}, the traffic {t[k]}")
        if not c.fused_updates:
            raise ValueError("the trainer's updates are not fused")
        lrn = self.config["learner"]
        if lrn["algorithm"] != "td3" or lrn["actor"] != "deterministic":
            raise ValueError(f"the configuration's learner is {lrn['algorithm']} with a "
                             f"{lrn['actor']} actor, the mode drives TD3's deterministic one")
        got = {"hidden": list(c.hidden), "obs_dim": tr.obs_dim, "act_dim": tr.action_dim}
        for k, v in got.items():
            if lrn[k] != v:
                raise ValueError(f"the trainer's learner has {k} {v}, the configuration {lrn[k]}")
        if lrn["hidden"] != [t["hidden"]] * len(lrn["hidden"]):
            raise ValueError(f"the configuration's widths {lrn['hidden']}, the traffic's "
                             f"hidden {t['hidden']}")
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
        one draw on the device; zero biases and padding rows; the targets
        equal to the actor and the critics."""
        h = self.t["hidden"]
        shapes = [(od, h), (h, h), (h, 2), (2, od + 2, h), (2, h, h), (2, h)]
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
        actor = dict(w1=a_w1, b1=zeros(h), w2=aw2, b2=zeros(h), wh=awh, bh=zeros(2))
        critic = dict(w1=c_w1, b1=zeros(2, h), w2=cw2, b2=zeros(2, h), w3=cw3, b3=zeros(2))
        return ref.Params(
            **{f"a_{k}": v for k, v in actor.items()},
            **{f"ta_{k}": v.clone() for k, v in actor.items()},
            **{f"c_{k}": v for k, v in critic.items()},
            **{f"t_{k}": v.clone() for k, v in critic.items()})

    def setup(self):
        from space_gym_torch.models import fused_td3

        tr = self.trainer = self._trainer()
        self.ft = fused_td3.build(self.t["hidden"])
        od = tr.obs_dim
        gen = self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        params = self.first_params(gen, od)
        # the benchmark's weights into the trainer's fresh state, through its
        # public format bridge
        actor, tactor, critic, tcritic = self.ft.unpack_params(
            self.ft.PackedParams(*[x.clone() for x in params]), od)
        st = tr.migrate_to_fused(tr.init(self.seed)._replace(
            actor_params=actor, target_actor_params=tactor, critic_params=critic,
            target_critic_params=tcritic))
        critics = self.ft.fused_unpack(st.fused)[0].c_w1.shape[0]
        if critics != self.config["learner"]["critics"]:
            raise ValueError(f"the trainer's learner has {critics} critics, the configuration "
                             f"{self.config['learner']['critics']}")
        u = torch.rand((self.lanes, tr.engine.n_reset_rand), generator=gen, device=self.device)
        env_state, obs = tr.engine.reset(self.lanes, u=u)
        self.state = st._replace(env_state=env_state, obs=obs)
        idx = torch.arange(self.lanes, device=self.device)
        self.start = (params, lanes_of(env_state, idx, torch.float64), obs.clone())

        self.gate = min(self.t["warmup_rows"], self.t["replay_rows"])
        self.obs_dim = od
        self.counts_before = program_counts()
        self.losses, self.moments, self.leaves = [], None, None
        self.first_calls = []  # per checked call: (generator state before it, its draws)
        while len(self.losses) < self.t["checked_updates"]:
            g0 = gen.get_state()
            with Draws(gen) as drawn:
                self.call()
            self.first_calls.append((g0, drawn))
            if self.live(len(self.first_calls)):
                m = self.last_metrics
                self.losses.append((m["critic_loss"].clone(), m["actor_loss"].clone()))
                p, adam = self.ft.fused_unpack(self.state.fused)
                if self.moments is None:
                    self.moments = [x.clone() for x in adam.m]
                self.leaves = [x.clone() for x in p]
        for _ in range(self.t["warmup_calls"]):
            self.call()
        self.done_sums.clear()

    def live(self, n: int) -> bool:
        """Whether the n-th call (from 1) updates the learner: the ring then
        holds the warm-up gate's rows."""
        return min(n * self.steps, self.t["replay_rows"]) >= self.gate

    def call(self) -> int:
        """One train_iter; returns its env-steps.  No host sync."""
        self.state, self.last_metrics = self.trainer.train_iter(self.state, self.generator)
        self.done_sums.append(self.last_metrics["episodes_done"])
        self.counted.append(program_counts())
        return self.lanes * self.steps

    # ---------------------------------------------------------- yardstick --
    def iter_ops(self) -> dict:
        """{"bf16": n, "f32": n}: one train_iter's network arithmetic: the
        rollout's deterministic-actor forwards and the K updates
        (roofline.td3_work)."""
        od, h = self.obs_dim, self.t["hidden"]
        _, ops = self.k6_work()
        fwd = 2 * self.lanes * self.steps * (od * h + h * h + h * 2)
        return {"bf16": ops["bf16"], "f32": ops["f32"] + fwd}

    def k6_work(self):
        """(bytes, ops) of one K6 launch, each sample's obs, next obs, action,
        reward and discount read once.  Its delayed updates are the
        benchmark's count: a launch starts at a multiple of K updates."""
        from ..roofline import td3_work

        t, od = self.t, self.obs_dim
        K = t["updates_per_iter"]
        n_act = delayed_updates(0, K, t["policy_delay"])
        return td3_work(t["hidden"], K, t["batch_size"], 2 * od + 4, od,
                        t["products"] == "bf16", n_act, self.lanes)

    # ---------------------------------------------------------- the check --
    def products(self) -> str:
        """The precision of the program's products: the mix's on the card;
        its plain version on the CPU takes float32."""
        return self.t["products"] if self.device.type == "cuda" else "float32"

    def last_call(self) -> dict:
        """The window's end state, one more call of the window's own on it
        under `Draws`, and what that call changed; the program is released
        after."""
        from space_gym_torch.models.replay import replay_cols

        st = self.state
        p0, adam0 = self.ft.fused_unpack(st.fused)
        idx = torch.arange(self.lanes, device=self.device)
        before = dict(
            p=[x.clone() for x in p0], m=[x.clone() for x in adam0.m],
            v=[x.clone() for x in adam0.v], count=int(adam0.count),
            count_a=int(adam0.count_a), ring=st.replay.data.clone(),
            cursor=st.replay.cursor, filled=st.replay.filled,
            lanes=lanes_of(st.env_state, idx, torch.float64), obs=st.obs.clone(),
            gstate=self.generator.get_state(), cols=replay_cols(self.obs_dim, 2))
        with Draws(self.generator) as drawn:
            self.call()
        st, m = self.state, self.last_metrics
        p1, adam1 = self.ft.fused_unpack(st.fused)
        after = dict(
            p=[x.clone() for x in p1], m=[x.clone() for x in adam1.m],
            count=int(adam1.count), count_a=int(adam1.count_a), ring=st.replay.data,
            lanes=lanes_of(st.env_state, idx, torch.float64),
            obs=[r.double() for r in st.obs.t()],
            loss=(float(m["critic_loss"]), float(m["actor_loss"])))
        self.release()
        return {"before": before, "after": after, "drawn": drawn}

    def _rollout(self, env, p, lanes, obs, gen, step=None):
        """`steps` steps of the actor (float32) with Gaussian exploration on
        the reference env from `lanes`, drawing a step's normals then its
        uniforms from `gen`; returns (lanes, obs, the steps' transitions, the
        step function)."""
        od = self.obs_dim
        rows = []
        for _ in range(self.steps):
            eps = torch.randn((self.lanes, 2), generator=gen, device=self.device)
            u = torch.rand((env.n_uniforms, self.lanes), generator=gen, device=self.device)
            o32 = obs.float()
            h1 = torch.relu(o32 @ p.a_w1[:od] + p.a_b1)
            a = torch.tanh(torch.relu(h1 @ p.a_w2 + p.a_b2) @ p.a_wh + p.a_bh)
            action = torch.clamp(a + self.t["explore_std"] * eps, -1.0, 1.0)
            if step is None:
                step = graph_step(env, lanes, action, u) if self.device.type == "cuda" \
                    else env.step
            st = step(lanes, action, u)
            rows.append((o32, action, st.reward.float(), torch.stack(st.final_obs, 1).float(),
                         1.0 - st.terminated.float()))
            lanes, obs = st.lanes, torch.stack(st.obs, 1)
        return lanes, obs, rows, step

    def _update(self, p, m, v, count, count_a, ring, drawn, products):
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
        return ref.update_k(p, m, v, count, count_a, batch, noises, obs_dim=self.obs_dim,
                            gamma=t["gamma"], tau=t["tau"], lr=t["lr"],
                            smooth_std=t["smooth_std"], smooth_clip=t["smooth_clip"],
                            policy_delay=t["policy_delay"], products=products)

    def follow(self, products: str):
        """The reference over the checked calls of set-up, from the first
        weights and the reset lanes: (losses, moments after the first
        updating call, leaves after the last)."""
        params, lanes, obs = self.start
        env = GoalEnv(self.config, torch.float64)
        gen = torch.Generator(device=self.device)
        p = params
        m = v = ref.Params(*[torch.zeros_like(x) for x in p])
        count = count_a = 0
        losses, moments = [], None
        ring, cursor, step = [None] * self.t["replay_rows"], 0, None
        for g0, drawn in self.first_calls:
            gen.set_state(g0)
            lanes, obs, rows, step = self._rollout(env, p, lanes, obs, gen, step)
            for r in rows:
                ring[cursor % len(ring)] = r
                cursor += 1
            if min(cursor, len(ring)) < self.gate:
                continue
            p, m, v, count, count_a, cl, al, qa = self._update(
                p, m, v, count, count_a, ring.__getitem__, drawn, products)
            losses.append((cl[-1], al[-1], qa[-1]))
            if moments is None:
                moments = list(m)
        return losses, moments, list(p)

    def follow_last(self, last: dict, products: str):
        """The reference over the window's end call, from the program's state
        at its start (its leaves, Adam state and counts, ring, lanes and
        generator state): (losses, moments, leaves, lanes, obs, the rollout's
        rows)."""
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
        p, m, _, _, _, cl, al, qa = self._update(p, ref.Params(*b["m"]), ref.Params(*b["v"]),
                                                 b["count"], b["count_a"], ring,
                                                 last["drawn"], products)
        return (float(cl[-1]), float(al[-1]), float(qa[-1])), list(m), list(p), lanes, obs, rows

    def counts_off(self):
        """update_counts_off over every call so far (module docstring)."""
        live = [self.live(i + 1) for i in range(len(self.counted))]
        return counts_off(self.counts_before, self.counted, live,
                          self.t["updates_per_iter"], self.t["policy_delay"])

    def check(self, control: bool = False) -> dict:
        """{name: value} of the numbers compared (module docstring).  With
        `control`, {"program": those, "control": the same numbers for the
        reference with float8 products in the program's place}."""
        start = list(self.start[0])
        got = (self.losses, self.moments, self.leaves)
        last = self.last_call()
        off = self.counts_off()
        products = ["fp8"] if control else []
        out = []
        for prod in [self.products()] + products:
            want = self.follow(prod)
            want_last = self.follow_last(last, prod)
            if not out:
                out.append({**compare(start, got, want), **compare_last(last, want_last)})
                if off is not None:
                    out[0]["update_counts_off"] = float(off)
                ref_start, ref_last = want, want_last
            else:  # the control in the program's place, against the reference
                ctrl_last = dict(last, after=dict(
                    last["after"], loss=want_last[0], m=want_last[1], p=want_last[2],
                    lanes=want_last[3], obs=list(want_last[4].t()),
                    ring=ring_of(last, want_last[5])))
                out.append({**compare(start, want, ref_start),
                            **compare_last(ctrl_last, ref_last)})
        if not control:
            return out[0]
        return {"program": out[0], "control": out[1]}

    def release(self):
        """Drop the program's state, trainer and captured graph.  The
        trainer's rollout closes over the trainer, so only the cyclic
        collector frees them: it runs here, and not inside the capture of
        the reference's step, where freeing a CUDA graph ends the capture."""
        self.state = self.trainer = self.last_metrics = None
        self.done_sums = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Draws(TorchFunctionMode):
    """Records what a call draws for the K-update from `generator`: its
    smoothing normals (a three-dimensional `torch.randn`) and its ring rows
    (a `torch.randint`), so that the reference takes the program's own."""

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
            elif func is torch.randn and out.dim() == 3:
                self.noises.append(out.clone())
        return out

    def update_draws(self):
        if len(self.noises) != 1 or len(self.rows) != 1:
            raise ValueError(f"an updating call drew {len(self.noises)} sets of normals and "
                             f"{len(self.rows)} of ring rows from its generator, not one each")
        return self.noises[0], self.rows[0]


def graph_step(env, lanes, action, u) -> GraphStep:
    """envcheck.GraphStep, captured with the cyclic collector held off: what
    it would free there (a CUDA graph of a run before) ends the capture."""
    gc.collect()
    gc.disable()
    try:
        return GraphStep(env, lanes, action, u)
    finally:
        gc.enable()


ADAM_LEAVES = ref.ACTOR + ref.CRITIC
FIELDS = ref.Params._fields


def leaves(xs, keys=FIELDS):
    return {k: xs[FIELDS.index(k)] for k in keys}


def compare(start, got, want) -> dict:
    """The three numbers of `got` (losses, moments, leaves) against `want`,
    the reference's, from the first leaves `start` (modes/sac.py::compare).
    A critic loss's gap is over the mean |critic loss| of the checked calls;
    an actor loss's over the mean of its batch's mean |Q1| (the reference's):
    the loss is -mean Q1, which can pass near zero where the values it
    averages do not."""
    g_loss, g_m, g_p = got
    w_loss, w_m, w_p = want
    g_loss = [(float(x[0]), float(x[1])) for x in g_loss]
    w_loss = [tuple(float(y) for y in x) for x in w_loss]  # critic, actor, mean |Q1|
    scales = (statistics.mean(abs(w[0]) for w in w_loss), statistics.mean(w[2] for w in w_loss))
    loss_gap = max(gap(g[j], w[j], scales[j]) for g, w in zip(g_loss, w_loss) for j in (0, 1))
    grad_gap, change_gap = leaf_gaps(leaves(start), leaves(g_m, ADAM_LEAVES), leaves(g_p),
                                     leaves(w_m, ADAM_LEAVES), leaves(w_p))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def compare_last(last: dict, want) -> dict:
    """The numbers of the window's end call against the reference's `want`
    (follow_last), as modes/sac.py::compare_last: the lanes and the ring, the
    call's last losses (its actor loss's gap over its batch's mean |Q1|, as
    in `compare`), and each leaf's change in the call, leaving out the
    leaves whose reference moment gained in the call is under a thousandth of
    the median.  A moment gained is m - b1^n m0 over the leaf's own Adam
    steps n in the call: K for the critics, the delayed ones for the actor."""
    b, a = last["before"], last["after"]
    w_loss, w_m, w_p, w_lanes, w_obs, w_rows = want
    steps = {f: a["count_a"] - b["count_a"] if f in ref.ACTOR else a["count"] - b["count"]
             for f in FIELDS}
    off = lanes_off(a["lanes"], a["obs"], w_lanes, list(w_obs.t()))
    w_ring, g_ring = ring_of(last, w_rows), a["ring"]
    d = (g_ring.double() - w_ring.double()).abs()
    off |= (~(d <= LANE_TOL * torch.clamp(w_ring.double().abs(), min=1.0))).any(0).any(0)
    (g_c, g_a), (w_c, w_a, w_q) = a["loss"][:2], w_loss
    loss_gap = max(gap(g_c, w_c, abs(w_c)), gap(g_a, w_a, w_q))

    def gained(m):
        return [x - B1 ** steps[f] * x0 for f, x, x0 in zip(FIELDS, m, b["m"])]
    _, change_gap = leaf_gaps(leaves(b["p"]), leaves(gained(a["m"]), ADAM_LEAVES),
                              leaves(a["p"]), leaves(gained(w_m), ADAM_LEAVES), leaves(w_p))
    return {"end_lanes_off_pct": 100.0 * float(off.sum()) / off.numel(),
            "end_loss_gap": loss_gap, "end_change_gap": change_gap}
