"""The port's Gaussian-diffusion tier (`core/gaussian.py`) against the JAX
package's, on the CPU: every `__all__` function over the mean_type x
var_type grid, `training_losses` over loss_type x var_type x P2, the
stop-gradient of the hybrid loss, classifier guidance, the respacing
tables and wrapper, and the p_sample / DDIM loops on tiny UNets (the 16^2
DDPM++ of the JAX base-training tests and the tiny OpenAI learn_sigma UNet
of `test_torch_openai.py`), with the noise drawn by hostrng bit for bit as
`jax.random.normal` draws it.

Inputs are numpy arrays from a seed, NCHW for the port and NHWC for JAX.
Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.core import gaussian as PG
from asyrp_official_torch.core.schedule import space_timesteps as p_space
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines.base_train import unet_eps_fn
from asyrp_official_torch.utils import hostrng
from asyrp_official_tpu.core import gaussian as JG
from asyrp_official_tpu.core.schedule import space_timesteps as j_space
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config

BETAS = np.linspace(1e-4, 0.02, 50)
PT, JT = PG.make_tables(BETAS), JG.make_tables(BETAS)
B, C, H = 3, 3, 8
T = np.array([0, 17, 49])  # t = 0 takes the decoder-NLL branch of the VLB
MEAN_TYPES = ("eps", "xstart", "xprev")
VAR_TYPES = ("fixedsmall", "fixedlarge", "learned", "learned_range")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nhwc(a):
    a = np.asarray(a)
    return np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else a


def nchw(a):
    a = np.asarray(a)
    return np.transpose(a, (0, 3, 1, 2)) if a.ndim == 4 else a


def _arrays(seed=0, c_out=C):
    rng = np.random.RandomState(seed)
    x0 = np.clip(rng.uniform(-1.1, 1.1, (B, C, H, H)), -1, 1).astype(np.float32)
    x = rng.randn(B, C, H, H).astype(np.float32)
    out = (rng.randn(B, c_out, H, H) * 0.5).astype(np.float32)
    return x0, x, out


def _both(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(nhwc(a))


def _tt():
    return torch.from_numpy(T), jnp.asarray(T, jnp.int32)


def _cmp(p, j, label, witness=None):
    """The port's result within 1e-4 of scale of JAX's; where `witness` (the
    port's function on float64 inputs) is given and that fails, the port no
    farther from the witness than 2x JAX is (the decoder NLL at t = 0 is a
    log of a difference of two nearly equal CDFs, ill-conditioned in
    float32 in either package)."""
    if isinstance(p, dict):
        assert set(p) == set(j), (set(p), set(j))
        for k in p:
            _cmp(p[k], j[k], f"{label}.{k}", None if witness is None else witness[k])
        return
    if isinstance(p, (tuple, list)):
        for i, (a, b) in enumerate(zip(p, j)):
            _cmp(a, b, f"{label}[{i}]", None if witness is None else witness[i])
        return
    want = nchw(np.asarray(j, np.float64))
    got = p.detach().double().numpy()
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if witness is None:
        close_to_scale(want, got, label)
        return
    scale = np.abs(want).max()
    if np.abs(got - want).max() <= 1e-4 * scale:
        return
    w = witness.detach().double().numpy()
    e_port, e_jax = np.abs(got - w).max(), np.abs(want - w).max()
    assert e_port <= 2.0 * e_jax, (label, e_port, e_jax, scale)


def _f64(*ts):
    return [t.double() for t in ts]


def test_tables_and_cosine_betas_equal_the_jax_package():
    for betas in (BETAS, PG.cosine_betas(60)):
        p, j = PG.make_tables(betas), JG.make_tables(betas)
        for f in ("betas", "alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2", "fixed_large_variance", "snr",
                  "sqrt_recipm1_alphas_cumprod", "alphas_cumprod_next"):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    np.testing.assert_array_equal(PG.cosine_betas(60), JG.cosine_betas(60))
    # the float32 table a gather reads is built once per device
    assert PT.table("posterior_variance", "cpu") is PT.table("posterior_variance", "cpu")


@pytest.mark.parametrize("fn", ["q_mean_variance", "q_sample", "q_posterior_mean_variance",
                                "predict_xstart_from_eps", "predict_xstart_from_xprev",
                                "predict_eps_from_xstart", "prior_bpd"])
def test_q_functions_and_reparameterizations_match_jax(fn):
    x0, x, out = _arrays()
    (px0, jx0), (px, jx), (po, jo) = _both(x0), _both(x), _both(out)
    pt, jt = _tt()
    args = {"q_mean_variance": ((px0, pt), (jx0, jt)),
            "q_sample": ((px0, pt, po), (jx0, jt, jo)),
            "q_posterior_mean_variance": ((px0, px, pt), (jx0, jx, jt)),
            "predict_xstart_from_eps": ((px, pt, po), (jx, jt, jo)),
            "predict_xstart_from_xprev": ((px, pt, po), (jx, jt, jo)),
            "predict_eps_from_xstart": ((px, pt, px0), (jx, jt, jx0)),
            "prior_bpd": ((px0,), (jx0,))}[fn]
    _cmp(getattr(PG, fn)(PT, *args[0]), getattr(JG, fn)(JT, *args[1]), fn)


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
@pytest.mark.parametrize("var_type", VAR_TYPES)
def test_p_mean_variance_and_vb_terms_match_jax(mean_type, var_type):
    learned = var_type.startswith("learned")
    x0, x, out = _arrays(1, 2 * C if learned else C)
    (px0, jx0), (px, jx), (po, jo) = _both(x0), _both(x), _both(out)
    pt, jt = _tt()
    kw = dict(mean_type=mean_type, var_type=var_type)
    _cmp(PG.p_mean_variance(PT, po, px, pt, **kw), JG.p_mean_variance(JT, jo, jx, jt, **kw),
         "p_mean_variance")
    _cmp(PG.p_mean_variance(PT, po, px, pt, clip_denoised=False, denoised_fn=lambda a: a * 0.5,
                            **kw),
         JG.p_mean_variance(JT, jo, jx, jt, clip_denoised=False, denoised_fn=lambda a: a * 0.5,
                            **kw), "p_mean_variance(denoised_fn)")
    _cmp(PG.vb_terms_bpd(PT, po, px0, px, pt, **kw), JG.vb_terms_bpd(JT, jo, jx0, jx, jt, **kw),
         "vb_terms_bpd", PG.vb_terms_bpd(PT, *_f64(po, px0, px), pt, **kw))


@pytest.mark.parametrize("var_type", ["fixedsmall", "learned_range"])
def test_single_steps_and_guidance_match_jax(var_type):
    learned = var_type.startswith("learned")
    _, x, out = _arrays(2, 2 * C if learned else C)
    (px, jx), (po, jo) = _both(x), _both(out)
    grad = np.random.RandomState(3).randn(B, C, H, H).astype(np.float32)
    (pg, jg) = _both(grad)
    pt, jt = _tt()
    key = hostrng.PRNGKey(5)
    jkey = jax.random.PRNGKey(5)
    kw = dict(var_type=var_type)
    _cmp(PG.p_sample(PT, po, px, pt, key, **kw), JG.p_sample(JT, jo, jx, jt, jkey, **kw),
         "p_sample")
    for eta in (0.0, 0.7):
        _cmp(PG.ddim_sample(PT, po, px, pt, key, eta=eta, **kw),
             JG.ddim_sample(JT, jo, jx, jt, jkey, eta=eta, **kw), f"ddim_sample eta={eta}")
    _cmp(PG.ddim_reverse_sample(PT, po, px, pt, **kw),
         JG.ddim_reverse_sample(JT, jo, jx, jt, **kw), "ddim_reverse_sample")
    pmv, jmv = PG.p_mean_variance(PT, po, px, pt, **kw), JG.p_mean_variance(JT, jo, jx, jt, **kw)
    _cmp(PG.condition_mean(pmv, pg), JG.condition_mean(jmv, jg), "condition_mean")
    _cmp(PG.condition_score(PT, pmv, px, pt, pg), JG.condition_score(JT, jmv, jx, jt, jg),
         "condition_score")


def test_noise_is_jax_normal_bit_for_bit():
    x = torch.zeros(2, 3, 16, 8)
    key = hostrng.split(hostrng.PRNGKey(9))[1]
    got = PG._normal_like(key, x)
    want = jax.random.normal(jax.random.split(jax.random.PRNGKey(9))[1], (2, 16, 8, 3))
    np.testing.assert_array_equal(got.numpy(), nchw(want))


def test_likelihood_helpers_match_jax():
    x0, x, out = _arrays(4)
    (px0, jx0), (px, jx), (po, jo) = _both(x0), _both(x), _both(out)
    _cmp(PG.normal_kl(px, po, px0, po * 0.5), JG.normal_kl(jx, jo, jx0, jo * 0.5), "normal_kl")
    _cmp(PG.normal_kl(px, po, 0.0, 0.0), JG.normal_kl(jx, jo, 0.0, 0.0), "normal_kl(0, 0)")
    _cmp(PG.discretized_gaussian_log_likelihood(px0, means=px * 0.1, log_scales=po),
         JG.discretized_gaussian_log_likelihood(jx0, means=jx * 0.1, log_scales=jo),
         "discretized_gaussian_log_likelihood")


def _model_fns(c_out, seed=6):
    """A model output that depends on x_t and on a parameter `w`:
    out = 0.3 * tile(x_t) + w, in both packages."""
    w = (np.random.RandomState(seed).randn(B, c_out, H, H) * 0.5).astype(np.float32)
    pw = torch.from_numpy(w).requires_grad_()
    jw = jnp.asarray(nhwc(w))
    reps = c_out // C
    pfn = lambda w_: (lambda xt, t: 0.3 * xt.repeat(1, reps, 1, 1) + w_)
    jfn = lambda w_: (lambda xt, t: 0.3 * jnp.tile(xt, (1, 1, 1, reps)) + w_)
    return pw, jw, pfn, jfn


LOSS_GRID = ([(lt, vt, "eps", p2) for lt in ("mse", "rescaled_mse", "kl", "rescaled_kl")
              for vt in VAR_TYPES for p2 in (0.0, 1.0)]
             + [("mse", "fixedsmall", mt, 0.0) for mt in ("xstart", "xprev")])


@pytest.mark.parametrize("loss_type,var_type,mean_type,p2_gamma", LOSS_GRID)
def test_training_losses_and_their_gradient_match_jax(loss_type, var_type, mean_type, p2_gamma):
    c_out = 2 * C if var_type.startswith("learned") else C
    x0, noise, _ = _arrays(7)
    (px0, jx0), (pn, jn) = _both(x0), _both(noise)
    pt, jt = _tt()
    pw, jw, pfn, jfn = _model_fns(c_out)
    kw = dict(mean_type=mean_type, var_type=var_type, loss_type=loss_type, p2_gamma=p2_gamma,
              p2_k=1.0)
    got = PG.training_losses(PT, pfn(pw), px0, pt, pn, **kw)
    want = JG.training_losses(JT, jfn(jw), jx0, jt, jn, **kw)
    pw64 = pw.detach().double().requires_grad_()
    witness = PG.training_losses(PT, pfn(pw64), *_f64(px0), pt, *_f64(pn), **kw)
    _cmp(got, want, f"training_losses {kw}", witness)
    # the gradient w.r.t. the model output's parameter: the hybrid loss
    # stops the mean's gradient in its VB term
    got["loss"].sum().backward()
    witness["loss"].sum().backward()
    jgrad = jax.grad(
        lambda w_: JG.training_losses(JT, jfn(w_), jx0, jt, jn, **kw)["loss"].sum())(jw)
    _cmp(pw.grad, jgrad, "d loss / d w", pw64.grad)


def test_respaced_tables_and_wrapper_match_jax():
    use = p_space(50, "10")
    assert use == j_space(50, "10") and p_space(50, "ddim5") == j_space(50, "ddim5")
    (ptab, pmap), (jtab, jmap) = PG.respaced_tables(BETAS, use), JG.respaced_tables(BETAS, use)
    np.testing.assert_array_equal(pmap, jmap)
    for f in ("betas", "alphas_cumprod", "posterior_variance", "snr"):
        np.testing.assert_array_equal(getattr(ptab, f), getattr(jtab, f), err_msg=f)
    with pytest.raises(ValueError, match="original_num_steps"):
        PG.wrap_model_for_respacing(lambda x, t: x, pmap, rescale_timesteps=True)
    seen = {}
    for rescale in (False, True):
        pw = PG.wrap_model_for_respacing(lambda x, t: t, pmap, rescale_timesteps=rescale,
                                         original_num_steps=50)
        jw = JG.wrap_model_for_respacing(lambda x, t: t, jmap, rescale_timesteps=rescale,
                                         original_num_steps=50)
        seen[rescale] = pw(None, torch.tensor([0, 3, 9]))
        np.testing.assert_array_equal(seen[rescale].numpy(),
                                      np.asarray(jw(None, jnp.asarray([0, 3, 9]))))
    assert seen[True].dtype == torch.float32 and seen[False].tolist() == [0, 16, 49]


_DDPMPP16 = {"data": {"dataset": "CelebA_HQ", "category": "CUSTOM", "image_size": 16,
                      "channels": 3},
             "model": {"ch": 32, "out_ch": 3, "ch_mult": [1, 2], "num_res_blocks": 1,
                       "attn_resolutions": [8], "in_channels": 3, "dropout": 0.0}}


def _unets():
    """(name, port model_fn, JAX model_fn, var_type, image size) for the
    16^2 DDPM++ (seeded init) and the tiny OpenAI learn_sigma UNet
    (perturbed init, so its eps is not zero)."""
    from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

    out = []
    for name, cfg, var_type, perturb in (("ddpmpp", _DDPMPP16, "fixedsmall", False),
                                         ("openai", OPENAI_TINY_CONFIG, "learned_range", True)):
        spec, jspec = spec_from_config(cfg), j_spec_from_config(cfg)
        tree = spec.init(hostrng.PRNGKey(3))
        if perturb:
            tree = perturbed(tree)
        model = spec.build()
        model.load_state_dict(spec.state_dict_from_jax(tree))
        jparams = jax.tree.map(jnp.asarray, tree)
        pfn = lambda x, t, m=model: unet_eps_fn(m, x, t)
        jfn = lambda x, t, s=jspec, p=jparams: s.apply(p, x, t.astype(jnp.float32))[0]
        out.append((name, pfn, jfn, var_type, cfg["data"]["image_size"]))
    return out


@pytest.fixture(scope="module")
def unets():
    return _unets()


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop", "ddim_eta1"])
def test_respaced_sample_loops_on_tiny_unets_match_jax(unets, which, loop):
    """Eight respaced steps of each loop on each UNet: the hostrng noise is
    JAX's, so the loops agree to float rounding."""
    name, pfn, jfn, var_type, size = unets[which]
    use = p_space(50, "8")
    (ptab, pmap), (jtab, jmap) = PG.respaced_tables(BETAS, use), JG.respaced_tables(BETAS, use)
    pm = PG.wrap_model_for_respacing(pfn, pmap)
    jm = JG.wrap_model_for_respacing(jfn, jmap)
    xT = np.random.RandomState(8).randn(2, 3, size, size).astype(np.float32)
    kw = dict(var_type=var_type)
    key, jkey = hostrng.PRNGKey(4), jax.random.PRNGKey(4)
    with torch.no_grad():
        if loop == "p_sample_loop":
            got = PG.p_sample_loop(pm, ptab, torch.from_numpy(xT), key, **kw)
            want = JG.p_sample_loop(jm, jtab, jnp.asarray(nhwc(xT)), jkey, **kw)
        else:
            eta = 1.0 if loop == "ddim_eta1" else 0.0
            got = PG.ddim_sample_loop(pm, ptab, torch.from_numpy(xT), key, eta=eta, **kw)
            want = JG.ddim_sample_loop(jm, jtab, jnp.asarray(nhwc(xT)), jkey, eta=eta, **kw)
    _cmp(got, want, f"{loop} {name}")
    assert np.abs(got.numpy() - xT).max() > 1e-2  # the loop moved x
