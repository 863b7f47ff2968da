"""Edit serving, a closed loop with one client: each request is a batch of
`batch` new images, sent to the program's serving path
`asyrp_official_torch.pipelines.engine.make_invert_edit` (DDIM inversion
over `n_inv_step`, then the asymmetric edited generation over
`n_test_step` with a DeltaBlock for t >= t_edit and eta = 1 noise for
t < t_addnoise), answered when the edited images are complete on the
device. The images and the eta noise of `pool` requests are drawn from the
seed in set-up; the noise reaches the chain through `noise_fn`.

The check, after the window, on a sample drawn from the seed: one slot
from each of `n_check` equal slices of the batch (slot 0 at batch 1). One
sampled request is run once more through the same serving path (the
witness), and the alphas, eta and noise that its step kernel (K3) is
handed at every step are held exactly to those the reference works out
itself from the schedule, the traffic and the seed, as is the eps_mod of
every step the reference does not edit to that step's eps. The traffic's
`check` picks what else is compared:

  * "chain": each sampled image, from a request drawn from those finished,
    is edited again by the reference from the same input and noise, one
    image at a time; compared are the edited images end to end.
  * "steps": for a chain too chaotic to compare end to end (bf16 with
    random weights), one request drawn from those finished is run once
    more through the same serving path, and the reference follows it step
    by step from the program's own states (`readings`, `reference`): at
    each step its own eps (and eps_mod where the step is edited) at the
    program's state, and its own DDIM update of that state, with its own
    timestep, alphas, eta and noise. The stages this skips are checked by
    themselves, exactly: the witness's last state is the window's answer,
    the first state the request's image, and each step starts from the
    last one's new state.
"""
from __future__ import annotations

import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from portbench import counting, program, weights
from portbench.reference import diffusion as rd
from portbench.reference.ops import RefOps, full_f32
from portbench.reference.unets import RefUNet
from portbench.trace import REQUEST_SPAN, Tracer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stochastic_slots(tr: dict) -> Dict[int, int]:
    """Generation step index -> index among the steps that draw eta noise."""
    steps = rd.generation_steps(rd.uniform_seq(tr["n_test_step"], tr["t_0"]))
    noisy = [i for i, (t, _) in enumerate(steps) if t < tr["t_addnoise"]]
    return {i: k for k, i in enumerate(noisy)}


class Cell:
    unit = "image"

    def __init__(self, cell, *, seed: int, device):
        from asyrp_official_torch.core.schedule import make_schedule, uniform_seq
        from asyrp_official_torch.models import delta
        from asyrp_official_torch.models.registry import spec_from_config
        from asyrp_official_torch.pipelines import engine

        self.marks = [("imports", time.perf_counter())]
        self.cfg, self.tr, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.tracer = Tracer(False)
        tr, cfg = self.tr, self.cfg
        self.dtype = tr["dtype"]
        self.batch, self.pool = tr["batch"], tr["pool"]
        diff = cfg["diffusion"]
        spec = spec_from_config(cfg)
        schedule = make_schedule(num_timesteps=diff["num_diffusion_timesteps"],
                                 beta_start=diff["beta_start"], beta_end=diff["beta_end"],
                                 var_type=cfg["model"].get("var_type", "fixedsmall"))
        self.model, self.unet_shapes = program.seeded_module(spec.build, seed, "unet", device)
        self.model.eval().requires_grad_(False)
        block_cls = delta.DeltaBlock if spec.delta_flavor == "ddpm" else delta.OpenAIDeltaBlock
        block, self.block_shapes = program.seeded_module(
            lambda: block_cls(spec.bottleneck_ch, spec.temb_ch), seed, "delta", device)
        self.edit = delta.EditState(blocks=(block.eval().requires_grad_(False),),
                                    hs_coeff=torch.tensor([1.0, 1.0], device=device),
                                    flavor=spec.delta_flavor, ignore_timestep=False)
        self.run = engine.make_invert_edit(
            spec, schedule, uniform_seq(tr["n_inv_step"], tr["t_0"]),
            uniform_seq(tr["n_test_step"], tr["t_0"]), t_edit=tr["t_edit"],
            t_addnoise=tr["t_addnoise"], compute_dtype=_DTYPES[self.dtype])
        program.sync(device)
        self.marks.append(("weights", time.perf_counter()))
        self.slots = _stochastic_slots(tr)
        size = cfg["data"]["image_size"]
        shape = (self.pool, self.batch, size, size, cfg["data"]["channels"])
        self.x0 = weights.uniform_images(shape, seed, device)
        self.noise = weights.normals((self.pool, len(self.slots)) + shape[1:], seed, "noise",
                                     device)
        self.outputs: List[torch.Tensor] = []
        self._items = None
        program.sync(device)
        self.marks.append(("inputs", time.perf_counter()))
        for _ in range(tr["warmup"]):  # the last pool slot: the window never reaches it
            self._edit(self.pool - 1)
        program.sync(device)
        self.marks.append(("warm-up", time.perf_counter()))

    def _edit(self, r: int):
        return self.run(self.model, self.edit, self.x0[r],
                        noise_fn=lambda step, shape: self.noise[r, self.slots[step]])

    def request(self, i: int) -> int:
        """The i-th request: the pool's slot i, cycling over the pool's
        first pool - 1 slots when a window outruns them."""
        with self.tracer.span(REQUEST_SPAN):
            x = self._edit(i % (self.pool - 1))
            program.sync(self.device)
        self.outputs.append(x)
        return self.batch

    def count(self) -> counting.Counter:
        """One image's work: 49 + 25 plain evals and 25 dual evals at the
        cell's batch, over the batch."""
        itemsize = torch.empty((), dtype=_DTYPES[self.dtype]).element_size()
        meta = {n: torch.empty(s, device="meta") for n, s in self.unet_shapes}
        block = {n: torch.empty(s, device="meta") for n, s in self.block_shapes}
        size = self.cfg["data"]["image_size"]
        x = torch.empty(self.batch, self.cfg["data"]["channels"], size, size, device="meta")
        t = torch.empty(self.batch, device="meta")
        n_dual = sum(t_ >= self.tr["t_edit"] for t_, _ in rd.generation_steps(
            rd.uniform_seq(self.tr["n_test_step"], self.tr["t_0"])))
        n_single = self.tr["n_inv_step"] - 1 + self.tr["n_test_step"] - n_dual
        total = counting.Counter(itemsize)
        with torch.no_grad():
            for n, dual in ((n_single, False), (n_dual, True)):
                c = counting.Counter(itemsize)
                unet = RefUNet(meta, self.cfg, RefOps("f32", c))
                h, hs, temb = unet.encode(x, t)
                unet.decode(h, hs, temb)
                if dual:
                    unet.decode(h + unet.delta(h, temb, block), hs, temb)
                for key, k in c.calls.items():
                    total.calls[key] += k * n
        # per image: a call's counts over the batch (exact: counts scale with the batch)
        per_image = counting.Counter(itemsize)
        for key, k in total.calls.items():
            per_image.calls[key] = k / self.batch
        return per_image

    def finish(self) -> None:
        del self.model, self.edit, self.run
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(request, slot) pairs drawn from the seed: one slot from each of
        n_check equal slices of the batch (slot 0 at batch 1). A "chain"
        check draws each pair's request from those finished; a "steps"
        check draws one request for all its slots."""
        n = self.tr["n_check"]
        rng = np.random.default_rng([self.seed % 2 ** 63, 11])
        edges = np.linspace(0, self.batch, n + 1).astype(int)
        slots = [int(rng.integers(edges[j], max(edges[j + 1], edges[j] + 1))) for j in range(n)]
        if self.tr["check"] == "steps":
            r = int(rng.integers(len(self.outputs)))
            return [(r, b) for b in slots]
        return [(int(rng.integers(len(self.outputs))), b) for b in slots]

    def items(self):
        if self._items is None:
            self._items = self.sample()
        return self._items

    def readings(self):
        """The witness: one sampled request run once more through the same
        serving path, recording at every DDIM step (K3) the sampled slots'
        state x, eps, eps_mod, alphas, eta, noise and new state ("chain":
        the first sampled image's request and slot; "steps": the sampled
        request and all its slots), with the window's answers and the
        request's inputs. "chain" adds the program's edited images of the
        sample, from the window."""
        from asyrp_official_torch.core import sampler

        items = self.items()
        if self.tr["check"] == "chain":
            r, slots = items[0][0], [items[0][1]]
        else:
            r, slots = items[0][0], [b for _, b in items]
        p = r % (self.pool - 1)
        real, calls = sampler.k3.ddim_step, []

        def rows(t):
            return None if t is None or t.shape[0] != self.batch else t[slots].float().clone()

        def record(x, eps, eps_mod, at, at_next, eta, noise=None, **kw):
            out = real(x, eps, eps_mod, at, at_next, eta, noise, **kw)
            calls.append({"x": rows(x), "eps": rows(eps), "eps_mod": rows(eps_mod),
                          "a": float(at), "a_next": float(at_next), "eta": float(eta),
                          "noise": rows(noise), "x_next": rows(out[0])})
            return out

        with mock.patch.object(sampler, "k3", _Calls(sampler.k3, ddim_step=record)):
            self._edit(p)
        program.sync(self.device)
        self._witnessed = {"p": p, "slots": slots, "answer": self.outputs[r][slots].float(),
                           "x0": self.x0[p][slots].float(), "calls": calls}
        got = {"witness": self._witnessed}
        if self.tr["check"] == "chain":
            got["images"] = [self.outputs[r][b:b + 1].float() for r, b in items]
        else:
            got["eps"] = [(c["eps"], c["eps_mod"]) for c in calls]
            got["x_next"] = [c["x_next"] for c in calls]
        return got

    def _steps(self):
        """(t, t_next, edited, eta, k) of each DDIM step of a request, by
        the reference's own rules: the inversion (eta 0), then the edited
        generation (edited where t >= t_edit; eta 1 where t < t_addnoise,
        drawing the k-th of the request's noises, else 0 and k None)."""
        tr = self.tr
        steps = [(t, tn, False, 0.0, None)
                 for t, tn in rd.inversion_steps(rd.uniform_seq(tr["n_inv_step"], tr["t_0"]))]
        k = 0
        for t, tn in rd.generation_steps(rd.uniform_seq(tr["n_test_step"], tr["t_0"])):
            noisy = t < tr["t_addnoise"]
            steps.append((t, tn, t >= tr["t_edit"], 1.0 if noisy else 0.0, k if noisy else None))
            k += int(noisy)
        return steps

    def reference(self, precision: str):
        """At each step of the witness, the alphas, eta and noise that the
        reference works out itself ("coef"). "chain": the reference's edited
        images of the sample, one at a time. "steps": at each recorded step
        and slot, the reference's eps and eps_mod (its eps where not edited)
        at the program's state, and the DDIM update of the program's state
        and eps (and eps_mod where edited) with the reference's own alphas,
        eta and noise (in f32; in bf16 for a control)."""
        sd = weights.draw_state(self.unet_shapes, self.seed, "unet", self.device)
        block = weights.draw_state(self.block_shapes, self.seed, "delta", self.device)
        unet = RefUNet(sd, self.cfg, RefOps(precision))
        d, tr = self.cfg["diffusion"], self.tr
        acp = rd.alphas_cumprod(d["beta_start"], d["beta_end"], d["num_diffusion_timesteps"])
        got = self._witnessed
        p, slots = got["p"], got["slots"]
        coef = []
        for t, tn, _, eta, k in self._steps():
            coef.append({"a": float(rd.alpha(acp, t, self.device)),
                         "a_next": float(rd.alpha(acp, tn, self.device)), "eta": eta,
                         "noise": None if k is None else self.noise[p, k][slots]})
        with full_f32():
            if tr["check"] == "chain":
                slot = [(r % (self.pool - 1), b) for r, b in self.items()]
                return {"coef": coef, "images": [rd.invert_edit(
                    unet, block, acp, self.x0[p, b:b + 1], n_inv_step=tr["n_inv_step"],
                    n_test_step=tr["n_test_step"], t_0=tr["t_0"], t_edit=tr["t_edit"],
                    t_addnoise=tr["t_addnoise"], noise=lambda k: self.noise[p, k, b:b + 1])
                    for p, b in slot]}
            step_dtype = torch.float32 if precision == "f32" else torch.bfloat16
            eps, x_next = [], []
            for c, w, (t, tn, edited, eta, _) in zip(got["calls"], coef, self._steps()):
                if c["x"] is None:
                    eps.append((None, None))
                    x_next.append(None)
                    continue
                pairs = [rd.eps_at(unet, c["x"][s:s + 1], t, block if edited else None)
                         for s in range(c["x"].shape[0])]
                e = torch.cat([e for e, _ in pairs])
                # where a step is not edited, the reference's eps_mod is its eps
                eps.append((e, torch.cat([m for _, m in pairs]) if edited else e))
                x, e, m, z = (None if v is None else v.to(step_dtype) for v in
                              (c["x"], c["eps"], c["eps_mod"] if edited else c["eps"],
                               w["noise"]))
                a, an = (torch.tensor(w[n], dtype=step_dtype, device=self.device)
                         for n in ("a", "a_next"))
                x_next.append(rd.ddim_step(x, e, m, a, an, eta, z)[0].float())
        return {"coef": coef, "eps": eps, "x_next": x_next}

    def gaps(self, got, want) -> Dict[str, float]:
        """"chain": over the sample, the worst image's relative RMS gap
        (`img_rel_rms`) and largest gap of any pixel (`img_max_abs`).
        "steps": over the recorded steps and slots, the worst relative RMS
        gap of eps and eps_mod (`eps_rel`; where a step is not edited, the
        eps_mod that K3 was handed is held to the reference's eps) and of
        the DDIM update (`step_rel`). For the program's readings also,
        from the witness: the largest gap of the alphas, eta and noise that
        K3 was handed from the reference's (`coef_exact`), and of the
        eps_mod that K3 was handed from its eps on the steps the reference
        does not edit (`unedited_exact`); "steps" adds the largest gap
        between the window's answers and the witness's last state
        (`answer_exact`) and of the chain's continuity: the first state
        against the request's images, each state against the last step's
        new state (`chain_exact`)."""
        inf = float("inf")
        if self.tr["check"] == "chain":
            pairs = list(zip(got["images"], want["images"]))
            out = {"img_rel_rms": max(_rel(g, w) for g, w in pairs),
                   "img_max_abs": max(float((g - w).abs().max()) for g, w in pairs)}
        else:
            eps_rel, step_rel = 0.0, 0.0
            if len(got["eps"]) != len(self._steps()):
                eps_rel = step_rel = inf
            for (ge, gm), (we, wm), gx, wx in zip(got["eps"], want["eps"], got["x_next"],
                                                  want["x_next"]):
                eps_rel = max(eps_rel, _rel(ge, we), _rel(gm, wm))
                step_rel = max(step_rel, _rel(gx, wx))
            out = {"eps_rel": eps_rel, "step_rel": step_rel}
        if "witness" not in got:
            return out
        wit, steps = got["witness"], self._steps()
        calls, coef = wit["calls"], want["coef"]
        if len(calls) != len(steps):
            return dict(out, coef_exact=inf, unedited_exact=inf, answer_exact=inf,
                        chain_exact=inf)
        out["coef_exact"] = max(
            max([abs(c[n] - w[n]) for n in ("a", "a_next", "eta")]
                + [0.0 if c["noise"] is None and w["noise"] is None
                   else _max_abs(c["noise"], w["noise"])])
            for c, w in zip(calls, coef))
        out["unedited_exact"] = max([_max_abs(c["eps_mod"], c["eps"])
                                     for c, (_, _, edited, _, _) in zip(calls, steps)
                                     if not edited], default=0.0)
        if self.tr["check"] == "steps":
            out["answer_exact"] = _max_abs(wit["answer"], calls[-1]["x_next"])
            links = [(calls[0]["x"], wit["x0"])]
            links += [(calls[i + 1]["x"], calls[i]["x_next"]) for i in range(len(calls) - 1)]
            out["chain_exact"] = max(_max_abs(a, b) for a, b in links)
        return out


class _Calls:
    """A module seen through a few of its functions replaced."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced.get(name) or getattr(self._module, name)


def _rel(g, w) -> float:
    if g is None or w is None or g.shape != w.shape:
        return float("inf")
    return float((g.float() - w.float()).norm() / w.float().norm())


def _max_abs(g, w) -> float:
    if g is None or w is None or g.shape != w.shape:
        return float("inf")
    return float((g.float() - w.float()).abs().max())
