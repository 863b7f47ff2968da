"""The full Gaussian-diffusion tier — the port of the JAX package's
`core/gaussian.py`: q/p distributions, the VLB in bits, the discretized
decoder likelihood, the p_sample / DDIM sample loops, classifier guidance,
the iDDPM/ADM training losses (learned-range hybrid, P2 weighting) and
timestep respacing.

Plain functions on tensors over a `GaussianTables` of float64 numpy
tables; each table a function reads is gathered per sample as float32
(the upstream's truncation), from a copy built once per device.

Conventions: images are NCHW, so a `learn_sigma` model output [B, 2C, H, W]
splits on dim 1 (the JAX package's NHWC splits on the last axis); `t` is an
integer [B] tensor of per-sample timestep indices. A model function is
`model_fn(x, t) -> output`, both NCHW.

Noise: `p_sample` / `ddim_sample` take a `utils/hostrng` key (uint32[2],
a `jax.random.PRNGKey`'s value) and draw `hostrng.normal` in the JAX
package's NHWC order, moved to NCHW, so the loops draw JAX's noise bit for
bit; a loop splits its key once per step, as the JAX scan does. The loops
are host `for` loops over the steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from asyrp_official_torch.utils import hostrng

__all__ = [
    "GaussianTables", "make_tables", "cosine_betas",
    "q_mean_variance", "q_sample", "q_posterior_mean_variance",
    "predict_xstart_from_eps", "predict_xstart_from_xprev",
    "predict_eps_from_xstart", "p_mean_variance",
    "p_sample", "ddim_sample", "ddim_reverse_sample",
    "condition_mean", "condition_score",
    "p_sample_loop", "ddim_sample_loop",
    "normal_kl", "discretized_gaussian_log_likelihood",
    "vb_terms_bpd", "training_losses", "prior_bpd",
    "respaced_tables", "wrap_model_for_respacing",
]


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """The iDDPM cosine schedule."""

    def alpha_bar(s):
        return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [
        min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps), max_beta)
        for i in range(num_timesteps)
    ]
    return np.asarray(betas, np.float64)


# tables derived from the fields, in float64 before the float32 cast
_DERIVED = {
    "one_minus_alphas_cumprod": lambda tab: 1.0 - tab.alphas_cumprod,
    "log_betas": lambda tab: np.log(tab.betas),
    "log_fixed_large_variance": lambda tab: np.log(tab.fixed_large_variance),
    "recip_posterior_mean_coef1": lambda tab: 1.0 / tab.posterior_mean_coef1,
    "posterior_mean_coef2_over_coef1":
        lambda tab: tab.posterior_mean_coef2 / tab.posterior_mean_coef1,
}


@dataclasses.dataclass(frozen=True)
class GaussianTables:
    """Per-timestep constants, float64 numpy. `table(name, device)` is the
    float32 copy of a field (or of a `_DERIVED` table, or of the P2 weight
    `("p2", k, gamma)`) on `device`, built at its first use there."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    fixed_large_variance: np.ndarray   # [pvar[1], betas[1:]]
    snr: np.ndarray
    _device_tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def table(self, name, device) -> torch.Tensor:
        key = (name, torch.device(device))
        out = self._device_tables.get(key)
        if out is None:
            if isinstance(name, tuple):  # ("p2", k, gamma)
                arr = 1.0 / (name[1] + self.snr) ** name[2]
            elif name in _DERIVED:
                arr = _DERIVED[name](self)
            else:
                arr = getattr(self, name)
            out = torch.as_tensor(np.asarray(arr, np.float32), device=device)
            self._device_tables[key] = out
        return out


def make_tables(betas: np.ndarray) -> GaussianTables:
    betas = np.asarray(betas, np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    pvar = betas * (1.0 - acp_prev) / (1.0 - acp)
    return GaussianTables(
        betas=betas,
        alphas_cumprod=acp,
        alphas_cumprod_prev=acp_prev,
        alphas_cumprod_next=acp_next,
        sqrt_alphas_cumprod=np.sqrt(acp),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
        log_one_minus_alphas_cumprod=np.log(1.0 - acp),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0),
        posterior_variance=pvar,
        posterior_log_variance_clipped=np.log(np.append(pvar[1], pvar[1:])),
        posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
        posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
        fixed_large_variance=np.append(pvar[1], betas[1:]),
        snr=acp / (1.0 - acp),
    )


def _gather(tab: GaussianTables, name, t, x) -> torch.Tensor:
    """The per-sample float32 value of table `name` at t, shaped to
    broadcast against x."""
    out = tab.table(name, x.device)[t]
    return out.reshape(out.shape[0], *([1] * (x.dim() - 1)))


def _split(model_output):
    """A learn_sigma output [B, 2C, ...] → (its first C channels, the last C)."""
    c = model_output.shape[1] // 2
    return model_output[:, :c], model_output[:, c:]


# ---------------------------------------------------------------------------
# q distributions
# ---------------------------------------------------------------------------

def q_mean_variance(tab: GaussianTables, x0, t):
    """q(x_t | x_0) → (mean, variance, log_variance)."""
    mean = _gather(tab, "sqrt_alphas_cumprod", t, x0) * x0
    var = _gather(tab, "one_minus_alphas_cumprod", t, x0)
    logvar = _gather(tab, "log_one_minus_alphas_cumprod", t, x0)
    return mean, var, logvar


def q_sample(tab: GaussianTables, x0, t, noise):
    """Diffuse x_0 for t steps."""
    return (_gather(tab, "sqrt_alphas_cumprod", t, x0) * x0
            + _gather(tab, "sqrt_one_minus_alphas_cumprod", t, x0) * noise)


def q_posterior_mean_variance(tab: GaussianTables, x0, xt, t):
    """q(x_{t-1} | x_t, x_0) → (mean, variance, log_variance)."""
    mean = (_gather(tab, "posterior_mean_coef1", t, xt) * x0
            + _gather(tab, "posterior_mean_coef2", t, xt) * xt)
    var = _gather(tab, "posterior_variance", t, xt)
    logvar = _gather(tab, "posterior_log_variance_clipped", t, xt)
    return mean, var, logvar


# ---------------------------------------------------------------------------
# x0 / eps reparameterizations
# ---------------------------------------------------------------------------

def predict_xstart_from_eps(tab, xt, t, eps):
    return (_gather(tab, "sqrt_recip_alphas_cumprod", t, xt) * xt
            - _gather(tab, "sqrt_recipm1_alphas_cumprod", t, xt) * eps)


def predict_xstart_from_xprev(tab, xt, t, xprev):
    return (_gather(tab, "recip_posterior_mean_coef1", t, xt) * xprev
            - _gather(tab, "posterior_mean_coef2_over_coef1", t, xt) * xt)


def predict_eps_from_xstart(tab, xt, t, x0):
    return ((_gather(tab, "sqrt_recip_alphas_cumprod", t, xt) * xt - x0)
            / _gather(tab, "sqrt_recipm1_alphas_cumprod", t, xt))


# ---------------------------------------------------------------------------
# p distribution from a model OUTPUT (the model call stays with the caller)
# ---------------------------------------------------------------------------

def p_mean_variance(
    tab: GaussianTables,
    model_output,
    x,
    t,
    *,
    mean_type: str = "eps",        # 'eps' | 'xstart' | 'xprev'
    var_type: str = "fixedsmall",  # 'learned' | 'learned_range' | 'fixedsmall' | 'fixedlarge'
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) as a function of the model output:
    `p_mean_variance(tab, model_fn(x, t), x, t, ...)`."""
    if var_type in ("learned", "learned_range"):
        model_output, var_values = _split(model_output)
        if var_type == "learned":
            logvar = var_values
        else:
            min_log = _gather(tab, "posterior_log_variance_clipped", t, x)
            max_log = _gather(tab, "log_betas", t, x)
            frac = (var_values + 1.0) / 2.0
            logvar = frac * max_log + (1.0 - frac) * min_log
        var = torch.exp(logvar)
    elif var_type == "fixedlarge":
        var = _gather(tab, "fixed_large_variance", t, x)
        logvar = _gather(tab, "log_fixed_large_variance", t, x)
    elif var_type == "fixedsmall":
        var = _gather(tab, "posterior_variance", t, x)
        logvar = _gather(tab, "posterior_log_variance_clipped", t, x)
    else:
        raise ValueError(f"unknown var_type {var_type!r}")

    def process(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        return torch.clamp(x0, -1.0, 1.0) if clip_denoised else x0

    if mean_type == "xprev":
        pred_xstart = process(predict_xstart_from_xprev(tab, x, t, model_output))
        mean = model_output
    elif mean_type in ("xstart", "eps"):
        pred_xstart = process(
            model_output if mean_type == "xstart"
            else predict_xstart_from_eps(tab, x, t, model_output)
        )
        mean, _, _ = q_posterior_mean_variance(tab, pred_xstart, x, t)
    else:
        raise ValueError(f"unknown mean_type {mean_type!r}")
    return {"mean": mean, "variance": var, "log_variance": logvar, "pred_xstart": pred_xstart}


# ---------------------------------------------------------------------------
# classifier guidance: cond_grad is ∇_x log p(y|x), e.g. the gradient of the
# EncoderUNet classifier's selected log-probability
# ---------------------------------------------------------------------------

def condition_mean(p_mean_var: Dict[str, torch.Tensor], cond_grad):
    """Shift the posterior mean by variance·∇ log p(y|x)."""
    return {**p_mean_var, "mean": p_mean_var["mean"] + p_mean_var["variance"] * cond_grad}


def condition_score(tab: GaussianTables, p_mean_var, x, t, cond_grad):
    """Condition the score (via eps), then rebuild pred_xstart and the
    posterior mean."""
    ab = _gather(tab, "alphas_cumprod", t, x)
    eps = predict_eps_from_xstart(tab, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1.0 - ab) * cond_grad
    out = dict(p_mean_var)
    out["pred_xstart"] = predict_xstart_from_eps(tab, x, t, eps)
    out["mean"], _, _ = q_posterior_mean_variance(tab, out["pred_xstart"], x, t)
    return out


# ---------------------------------------------------------------------------
# single steps
# ---------------------------------------------------------------------------

def _normal_like(key, x):
    """hostrng's standard normal of x's NHWC shape (the JAX package's
    layout), as an NCHW tensor like x."""
    shape = (x.shape[0], *x.shape[2:], x.shape[1])
    noise = torch.from_numpy(hostrng.normal(np.asarray(key), shape))
    return noise.movedim(-1, 1).to(device=x.device, dtype=x.dtype)


def _nonzero(t, x):
    return (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def p_sample(tab, model_output, x, t, key, **kw):
    """Ancestral step; no noise at t == 0."""
    out = p_mean_variance(tab, model_output, x, t, **kw)
    noise = _normal_like(key, x)
    sample = out["mean"] + _nonzero(t, x) * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_sample(tab, model_output, x, t, key=None, *, eta: float = 0.0, **kw):
    """DDIM step, eq. 12; noise from `key` where eta != 0."""
    out = p_mean_variance(tab, model_output, x, t, **kw)
    eps = predict_eps_from_xstart(tab, x, t, out["pred_xstart"])
    ab = _gather(tab, "alphas_cumprod", t, x)
    ab_prev = _gather(tab, "alphas_cumprod_prev", t, x)
    sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab)) * torch.sqrt(1 - ab / ab_prev)
    mean_pred = (out["pred_xstart"] * torch.sqrt(ab_prev)
                 + torch.sqrt(1 - ab_prev - sigma ** 2) * eps)
    if eta == 0.0 or key is None:
        sample = mean_pred
    else:
        sample = mean_pred + _nonzero(t, x) * sigma * _normal_like(key, x)
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_reverse_sample(tab, model_output, x, t, **kw):
    """DDIM reverse ODE step x_t → x_{t+1}."""
    out = p_mean_variance(tab, model_output, x, t, **kw)
    eps = predict_eps_from_xstart(tab, x, t, out["pred_xstart"])
    ab_next = _gather(tab, "alphas_cumprod_next", t, x)
    mean_pred = out["pred_xstart"] * torch.sqrt(ab_next) + torch.sqrt(1 - ab_next) * eps
    return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}


# ---------------------------------------------------------------------------
# sampling loops
# ---------------------------------------------------------------------------

def _loop(step_fn, model_fn, tab, noise, key, timesteps=None):
    ts = list(reversed(range(tab.num_timesteps))) if timesteps is None else timesteps
    x, key = noise, np.asarray(key)
    for t_i in ts:
        key, sub = hostrng.split(key)
        t = torch.full((x.shape[0],), int(t_i), dtype=torch.long, device=x.device)
        x = step_fn(tab, model_fn(x, t), x, t, sub)["sample"]
    return x


def p_sample_loop(model_fn, tab, noise, key, *, timesteps=None, **kw):
    """The ancestral loop from `noise` (x_T) over `timesteps` (descending;
    default the whole grid). Pair with `respaced_tables` +
    `wrap_model_for_respacing` for a respaced process."""
    return _loop(lambda tab, mo, x, t, sub: p_sample(tab, mo, x, t, sub, **kw),
                 model_fn, tab, noise, key, timesteps=timesteps)


def ddim_sample_loop(model_fn, tab, noise, key, *, eta: float = 0.0, timesteps=None, **kw):
    return _loop(lambda tab, mo, x, t, sub: ddim_sample(tab, mo, x, t, sub, eta=eta, **kw),
                 model_fn, tab, noise, key, timesteps=timesteps)


# ---------------------------------------------------------------------------
# likelihoods / VLB
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL of two diagonal Gaussians; numbers are taken as tensors like the
    tensor arguments."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2) if torch.is_tensor(a))
    mean1, logvar1, mean2, logvar2 = (
        a if torch.is_tensor(a) else torch.tensor(a, dtype=like.dtype, device=like.device)
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x * x * x))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of the Gaussian discretized to uint8 bins scaled to
    [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_std_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_std_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def _mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=1)


def vb_terms_bpd(tab, model_output, x0, xt, t, *, clip_denoised: bool = True, **kw):
    """One VLB term in bits: KL of the true posterior vs the model
    posterior, or the decoder NLL at t == 0."""
    true_mean, _, true_logvar = q_posterior_mean_variance(tab, x0, xt, t)
    out = p_mean_variance(tab, model_output, xt, t, clip_denoised=clip_denoised, **kw)
    kl = _mean_flat(normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"])) \
        / math.log(2.0)
    decoder_nll = _mean_flat(-discretized_gaussian_log_likelihood(
        x0, means=out["mean"], log_scales=0.5 * out["log_variance"])) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def training_losses(
    tab: GaussianTables,
    model_fn: Callable,
    x0,
    t,
    noise,
    *,
    mean_type: str = "eps",
    var_type: str = "fixedsmall",
    loss_type: str = "mse",        # 'mse' | 'rescaled_mse' | 'kl' | 'rescaled_kl'
    p2_gamma: float = 0.0,
    p2_k: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """iDDPM/ADM training losses, per sample: the learned-range hybrid
    objective (the VB term with the mean's gradient stopped) and the P2
    weighting 1 / (k + snr)^gamma."""
    xt = q_sample(tab, x0, t, noise)
    terms: Dict[str, torch.Tensor] = {}
    if loss_type in ("kl", "rescaled_kl"):
        terms["loss"] = vb_terms_bpd(tab, model_fn(xt, t), x0, xt, t, clip_denoised=False,
                                     mean_type=mean_type, var_type=var_type)["output"]
        if loss_type == "rescaled_kl":
            terms["loss"] = terms["loss"] * tab.num_timesteps
        return terms

    model_output = model_fn(xt, t)
    if var_type in ("learned", "learned_range"):
        mean_out, var_values = _split(model_output)
        frozen = torch.cat([mean_out.detach(), var_values], dim=1)
        terms["vb"] = vb_terms_bpd(tab, frozen, x0, xt, t, clip_denoised=False,
                                   mean_type=mean_type, var_type=var_type)["output"]
        if loss_type == "rescaled_mse":
            terms["vb"] = terms["vb"] * (tab.num_timesteps / 1000.0)
        model_output = mean_out

    if mean_type == "xprev":
        target = q_posterior_mean_variance(tab, x0, xt, t)[0]
    elif mean_type == "xstart":
        target = x0
    elif mean_type == "eps":
        target = noise
    else:
        raise KeyError(mean_type)
    weight = _gather(tab, ("p2", float(p2_k), float(p2_gamma)), t, target)
    terms["mse"] = _mean_flat(weight * (target - model_output) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    return terms


def prior_bpd(tab: GaussianTables, x0):
    """KL(q(x_T | x_0) || N(0, I)) in bits."""
    t = torch.full((x0.shape[0],), tab.num_timesteps - 1, dtype=torch.long, device=x0.device)
    mean, _, logvar = q_mean_variance(tab, x0, t)
    return _mean_flat(normal_kl(mean, logvar, 0.0, 0.0)) / math.log(2.0)


# ---------------------------------------------------------------------------
# timestep respacing
# ---------------------------------------------------------------------------

def respaced_tables(betas: np.ndarray, use_timesteps) -> Tuple[GaussianTables, np.ndarray]:
    """Keep a subset of the original process's timesteps: the new betas keep
    alphas_cumprod at the kept steps. Returns (tables over the respaced grid,
    timestep_map: respaced index → original timestep)."""
    keep = set(int(t) for t in use_timesteps)
    acp = np.cumprod(1.0 - np.asarray(betas, np.float64))
    last = 1.0
    new_betas, tmap = [], []
    for i, a in enumerate(acp):
        if i in keep:
            new_betas.append(1.0 - a / last)
            last = a
            tmap.append(i)
    return make_tables(np.asarray(new_betas)), np.asarray(tmap, np.int32)


def wrap_model_for_respacing(
    model_fn: Callable,
    timestep_map: np.ndarray,
    *,
    rescale_timesteps: bool = False,
    original_num_steps: Optional[int] = None,
) -> Callable:
    """Respaced indices → original timesteps before the model sees them
    (scaled to a 1000-step grid with `rescale_timesteps`)."""
    if rescale_timesteps and original_num_steps is None:
        raise ValueError(
            "rescale_timesteps=True requires original_num_steps (the length of the "
            "UNRESPACED schedule, which the rescale divides by)")
    tmaps: Dict[torch.device, torch.Tensor] = {}

    def wrapped(x, t, **kw):
        tmap = tmaps.get(t.device)
        if tmap is None:
            tmap = tmaps[t.device] = torch.as_tensor(np.asarray(timestep_map), device=t.device)
        new_t = tmap[t]
        if rescale_timesteps:
            new_t = new_t.to(torch.float32) * (1000.0 / original_num_steps)
        return model_fn(x, new_t, **kw)

    return wrapped
