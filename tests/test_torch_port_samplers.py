"""Port parity of the samplers and the diffusion process against the JAX
package, on the CPU: diffusion/losses.py, the rest of GaussianDiffusion
(q_*, predict_*, p_mean_variance, the sampling loops, calc_bpd_loop,
_vb_terms, the learned-variance training term), diffusion/respace.py,
utils/script_util.py, and the rest of diffusion/dpm_solver.py
(from_alphas_cumprod, model_wrapper's model and guidance types,
algorithm_type "dpmsolver", the time grids, singlestep, singlestep_fixed,
the adaptive solver, t_start / t_end, lower_order_final, inverse).

Inputs are numpy draws from a seed handed to both packages; the models
are small closed-form functions written in both frameworks.

Tolerance: rel L2 <= 1e-5 (TOL) for every float result, the same fp32
formulas; index sets, schedules' tables and counts exactly. Two kinds of
solver run take 1e-4 (TOL_STIFF): the noise-prediction algorithm
("dpmsolver") and `inverse`. Their steps at the noisy end (alpha_T =
0.006) cancel terms hundreds of times their result, and XLA's exp and
expm1 differ from torch's in the last bit at some times (expm1(h / 2) at
the step from t = 1 to 0.75025, checked bit by bit: every other input of
that step agrees to the bit), which the cancellation lifts to 3.0e-5
(singlestep_fixed, order 2) and 6.3e-5 (inverse, singlestep). The
adaptive solver must take JAX's number of iterations and accept as many
steps (a flip of one accept/reject decision, where
err sits within rounding of 1, would fail the test and shows in its
message). `p_sample_loop` and `calc_bpd_loop` draw noise inside the loop
from JAX's PRNG, which the port cannot reproduce: their deterministic
parts are held exactly (the loops given the same noise through an
all-zero inpainting mask, `calc_bpd_loop`'s prior_bpd, `_vb_terms` per t)
and their sampled outputs by distribution, batch means within 5 standard
errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvfdiffusion_torch.diffusion import dpm_solver as pdpm
from gvfdiffusion_torch.diffusion import gaussian_diffusion as pgd
from gvfdiffusion_torch.diffusion import losses as plosses
from gvfdiffusion_torch.diffusion import respace as prespace
from gvfdiffusion_torch.utils import script_util as psu
from gvfdiffusion_tpu.diffusion import dpm_solver as jdpm
from gvfdiffusion_tpu.diffusion import gaussian_diffusion as jgd
from gvfdiffusion_tpu.diffusion import losses as jlosses
from gvfdiffusion_tpu.diffusion import respace as jrespace
from gvfdiffusion_tpu.utils import script_util as jsu

TOL = 1e-5
# one shape for the diffusion process's tests: JAX compiles each operation
# once a shape
X = (4, 3, 5)
TOL_STIFF = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    assert _rel(got, want) <= tol, _rel(got, want)


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- losses -------------------------------------------------------------------


def test_losses_match_jax():
    m1, m2, x = (_draw(s, 3, 7) for s in (1, 2, 3))
    v1, v2 = (0.5 * _draw(s, 3, 7) for s in (4, 5))
    t, j = torch.from_numpy, jnp.asarray
    _close(plosses.normal_kl(t(m1), t(v1), t(m2), t(v2)),
           jlosses.normal_kl(j(m1), j(v1), j(m2), j(v2)))
    _close(plosses.approx_standard_normal_cdf(t(x)),
           jlosses.approx_standard_normal_cdf(j(x)))
    # x on the 1/255 grid of [-1, 1], both ends included; means near x and
    # scales near the bin width, so that each bin's probability, a
    # difference of two CDFs, keeps fp32 digits (far in a tail it is a
    # difference of nearly equal numbers in either package)
    xs = np.round(np.clip(x * 0.6, -1, 1) * 127.5) / 127.5
    xs[0, :2] = (-1.0, 1.0)
    means = xs + 0.01 * _draw(6, 3, 7)
    logs = -4.5 + 0.3 * _draw(7, 3, 7)
    _close(plosses.discretized_gaussian_log_likelihood(
        t(xs), means=t(means), log_scales=t(logs)),
        jlosses.discretized_gaussian_log_likelihood(
            j(xs), means=j(means), log_scales=j(logs)))


# -- respacing and script helpers --------------------------------------------


@pytest.mark.parametrize("counts", ["ddim25", "fast10", "fast40", "10,10,5",
                                    [5, 3], "4", "1000"])
def test_space_timesteps_match_jax(counts):
    assert prespace.space_timesteps(1000, counts) == \
        jrespace.space_timesteps(1000, counts)


@pytest.mark.parametrize("respacing", [None, "ddim10", "7,3"])
def test_spaced_diffusion_tables_match_jax(respacing):
    kw = dict(schedule="cosine", steps=1000, timestep_respacing=respacing,
              mean_type="eps", var_type="learned_range",
              rescale_timesteps=True)
    pd, jd = prespace.spaced_diffusion(**kw), jrespace.spaced_diffusion(**kw)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2",
              "sqrt_recipm1_alphas_cumprod", "timestep_map"):
        np.testing.assert_array_equal(getattr(pd, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert (pd.num_timesteps, pd.original_num_steps) == (
        jd.num_timesteps, jd.original_num_steps)
    t = np.arange(pd.num_timesteps)
    _close(pd.scaled_model_t(torch.from_numpy(t)),
           jd.scaled_model_t(jnp.asarray(t)))


def test_init_volume_grid_matches_jax():
    for normalize in (True, False):
        np.testing.assert_array_equal(psu.init_volume_grid(5, normalize),
                                      jsu.init_volume_grid(5, normalize))


@pytest.mark.parametrize("mean_type", ["eps", "v", "x0"])
def test_predict_x0_from_q_matches_jax(mean_type):
    pd, jd = _diffusions(mean_type=mean_type)
    x0, noise, out = (_draw(s, *X) for s in (8, 9, 10))
    t = np.array([0, 3, 500, 999])
    _close(psu.predict_x0_from_q(pd, *map(torch.from_numpy,
                                          (x0, t, noise, out))),
           jsu.predict_x0_from_q(jd, *map(jnp.asarray, (x0, t, noise, out))))


# -- the diffusion process ----------------------------------------------------


def _diffusions(respacing=None, **kw):
    kw = dict(dict(schedule="cosine", steps=1000, mean_type="v",
                   var_type="fixed_small"), **kw)
    if respacing:
        return (prespace.spaced_diffusion(timestep_respacing=respacing, **kw),
                jrespace.spaced_diffusion(timestep_respacing=respacing, **kw))
    return pgd.create_diffusion(**kw), jgd.create_diffusion(**kw)


def _toy_denoisers(channels, learned):
    """The same per-element model in both frameworks: tanh(a x + 1e-3 t + b
    k) over x [B, ..., C] and a kwarg k; 2C outputs for the learned
    variance types (the variance half in [-1, 1])."""
    a, b = _draw(11, channels), _draw(12, channels)

    def body(mod, x, t, k):
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1))
        out = mod.tanh(x * a + 1e-3 * tt + b * k)
        if learned:
            out = (mod.concatenate if mod is jnp else torch.cat)(
                [out, mod.tanh(0.5 * x - b)], -1)
        return out

    return (lambda x, t, k=0.0: body(torch, x, t.float(), k),
            lambda x, t, k=0.0: body(jnp, x, t, k))


def test_q_and_predict_helpers_match_jax():
    pd, jd = _diffusions()
    x0, xt, e = (_draw(s, *X) for s in (13, 14, 15))
    t = np.array([0, 1, 417, 999])
    P, J = (lambda *a: tuple(map(torch.from_numpy, a)),
            lambda *a: tuple(map(jnp.asarray, a)))
    for got, want in zip(pd.q_mean_variance(*P(x0, t)),
                         jd.q_mean_variance(*J(x0, t))):
        _close(got.expand(x0.shape), jnp.broadcast_to(want, x0.shape))
    for got, want in zip(pd.q_posterior_mean_variance(*P(x0, xt, t)),
                         jd.q_posterior_mean_variance(*J(x0, xt, t))):
        _close(got.expand(x0.shape), jnp.broadcast_to(want, x0.shape))
    for name in ("predict_xstart_from_eps", "predict_xstart_from_v",
                 "predict_xstart_from_xprev", "predict_eps_from_xstart"):
        _close(getattr(pd, name)(*P(xt, t, e)),
               getattr(jd, name)(*J(xt, t, e)))


@pytest.mark.parametrize("var_type", list(pgd.VAR_TYPES))
@pytest.mark.parametrize("threshold", [0.99, None, "no_clip"])
def test_p_mean_variance_matches_jax(var_type, threshold):
    """Every variance type with the dynamic-threshold quantile clip, the
    [-1, 1] clamp (threshold None) and no clip."""
    pd, jd = _diffusions(var_type=var_type)
    pm, jm = _toy_denoisers(5, var_type.startswith("learned"))
    x = 1.5 * _draw(16, *X)
    t = np.array([0, 250, 998, 999])
    clip = threshold != "no_clip"
    thr = None if threshold == "no_clip" else threshold
    got = pd.p_mean_variance(pm, torch.from_numpy(x), torch.from_numpy(t),
                             clip, dynamic_threshold=thr,
                             model_kwargs=dict(k=0.3))
    want = jd.p_mean_variance(jm, jnp.asarray(x), jnp.asarray(t), clip,
                              dynamic_threshold=thr,
                              model_kwargs=dict(k=0.3))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        _close(got[k].expand(x.shape), jnp.broadcast_to(want[k], x.shape))


@pytest.mark.parametrize("mean_type", ["eps", "x0", "xprev"])
def test_p_mean_variance_mean_types_match_jax(mean_type):
    pd, jd = _diffusions(mean_type=mean_type)
    pm, jm = _toy_denoisers(5, False)
    x = _draw(17, *X)
    t = np.array([3, 700, 1, 999])
    got = pd.p_mean_variance(pm, torch.from_numpy(x), torch.from_numpy(t))
    want = jd.p_mean_variance(jm, jnp.asarray(x), jnp.asarray(t))
    for k in ("mean", "pred_xstart"):
        _close(got[k], want[k])


@pytest.mark.parametrize("loop", ["ddim", "p_sample"])
def test_sample_loops_deterministic_parts_match_jax(loop):
    """DDIM at eta 0 from the same noise; both loops with an inpainting
    mask that keeps half the elements (kept exactly) and resamples the
    other half (DDIM: equal to JAX there too)."""
    pd, jd = _diffusions("10", var_type="fixed_large")
    pm, jm = _toy_denoisers(5, False)
    noise = _draw(18, *X)
    mask = np.zeros((1,) + X[1:], np.float32)
    mask[:, :2] = 1.0
    kw = dict(clip_denoised=True, dynamic_threshold=0.95)
    name = f"{loop}_sample_loop" if loop == "ddim" else "p_sample_loop"
    got = getattr(pd, name)(pm, noise.shape,
                            generator=torch.Generator().manual_seed(0),
                            noise=torch.from_numpy(noise),
                            inpainting_mask=torch.from_numpy(mask), **kw)
    want = getattr(jd, name)(jm, noise.shape, jax.random.PRNGKey(0),
                             noise=jnp.asarray(noise),
                             inpainting_mask=jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got.numpy()[:, 2:], noise[:, 2:])
    np.testing.assert_array_equal(np.asarray(want)[:, 2:], noise[:, 2:])
    if loop == "ddim":
        _close(got, want)
        full = pd.ddim_sample_loop(pm, noise.shape,
                                   noise=torch.from_numpy(noise), **kw)
        _close(full, jd.ddim_sample_loop(jm, noise.shape,
                                         jax.random.PRNGKey(1),
                                         noise=jnp.asarray(noise), **kw))


def _within_standard_errors(got, want, k=5.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    se = np.sqrt(got.var(0) / len(got) + want.var(0) / len(want))
    diff = np.abs(got.mean(0) - want.mean(0))
    assert (diff <= k * se + 1e-6).all(), (diff / np.maximum(se, 1e-12)).max()


def test_p_sample_loop_matches_jax_in_distribution():
    """1024 ancestral samples from one starting point in each package:
    per-element means within 5 standard errors, standard deviations
    within 10%."""
    pd, jd = _diffusions("8", var_type="fixed_small")
    pm, jm = _toy_denoisers(3, False)
    n = 1024
    start = np.broadcast_to(_draw(19, 1, 3), (n, 3)).copy()
    got = pd.p_sample_loop(pm, start.shape,
                           generator=torch.Generator().manual_seed(3),
                           noise=torch.from_numpy(start),
                           clip_denoised=False).numpy()
    want = np.asarray(jd.p_sample_loop(jm, start.shape, jax.random.PRNGKey(3),
                                       noise=jnp.asarray(start),
                                       clip_denoised=False))
    _within_standard_errors(got, want)
    ratio = got.std(0) / want.std(0)
    assert (np.abs(ratio - 1) <= 0.1).all(), ratio


@pytest.mark.parametrize("var_type", ["fixed_small", "learned_range"])
def test_vb_terms_match_jax(var_type):
    """The bound's term at each t of a 6-step process, t = 0 the decoder
    NLL, on the same x_t."""
    pd, jd = _diffusions("6", var_type=var_type, mean_type="eps")
    pm, jm = _toy_denoisers(5, var_type == "learned_range")
    x0 = np.clip(0.5 * _draw(20, *X), -1, 1)
    xt = _draw(21, *X)
    for step in range(pd.num_timesteps):
        t = np.full(X[0], step)
        got = pd._vb_terms(pm, torch.from_numpy(x0), torch.from_numpy(xt),
                           torch.from_numpy(t))
        want = jd._vb_terms(jm, jnp.asarray(x0), jnp.asarray(xt),
                            jnp.asarray(t))
        _close(got["output"], want["output"])
        _close(got["pred_xstart"], want["pred_xstart"])


def test_calc_bpd_loop_matches_jax():
    """prior_bpd exactly; the bound's terms (vb, mse, total) by
    distribution over 256 samples."""
    pd, jd = _diffusions("5", var_type="learned", mean_type="eps")
    pm, jm = _toy_denoisers(2, True)
    x0 = np.clip(0.4 * _draw(22, 256, 3, 2), -1, 1)
    got = pd.calc_bpd_loop(pm, torch.from_numpy(x0),
                           generator=torch.Generator().manual_seed(4))
    want = jd.calc_bpd_loop(jm, jnp.asarray(x0), jax.random.PRNGKey(4))
    _close(got["prior_bpd"], want["prior_bpd"])
    for k in ("total_bpd", "vb", "xstart_mse", "mse"):
        assert got[k].shape == want[k].shape, k
        _within_standard_errors(got[k].numpy(), want[k])
    _close(got["total_bpd"], got["vb"].sum(1) + got["prior_bpd"])


@pytest.mark.parametrize("var_type", ["learned", "learned_range"])
def test_learned_variance_training_losses_match_jax(var_type):
    pd, jd = _diffusions(var_type=var_type, mean_type="eps", min_snr=True)
    pm, jm = _toy_denoisers(5, True)
    x0, noise = _draw(23, *X), _draw(24, *X)
    t = np.array([0, 10, 500, 999])
    got, _ = pd.training_losses(pm, torch.from_numpy(x0), torch.from_numpy(t),
                                torch.from_numpy(noise))
    want, _ = jd.training_losses(jm, jnp.asarray(x0), jnp.asarray(t),
                                 jax.random.PRNGKey(0),
                                 noise=jnp.asarray(noise))
    for k in ("vb", "mse", "loss"):
        _close(got[k], want[k])


# -- DPM-Solver --------------------------------------------------------------


def _schedules():
    betas = jgd.get_named_beta_schedule("cosine", 1000)
    return (pdpm.NoiseScheduleVP.from_betas(betas),
            jdpm.NoiseScheduleVP.from_betas(betas))


def test_from_alphas_cumprod_matches_jax():
    acp = np.cumprod(1.0 - jgd.get_named_beta_schedule("linear", 1000))
    p = pdpm.NoiseScheduleVP.from_alphas_cumprod(acp)
    j = jdpm.NoiseScheduleVP.from_alphas_cumprod(acp)
    assert p.total_N == j.total_N
    np.testing.assert_array_equal(p.t_array.numpy(), np.asarray(j.t_array))
    np.testing.assert_array_equal(p.log_alpha_array.numpy(),
                                  np.asarray(j.log_alpha_array))


def test_inverse_lambda_returns_to_t0():
    """The adaptive solver stops at |s - t_0| <= 1e-5: lambda^-1(lambda(t))
    must come back to within that at the end of the schedule."""
    pns, _ = _schedules()
    for t0 in (1.0 / pns.total_N, 0.01, 0.5):
        back = pns.inverse_lambda(pns.marginal_lambda(torch.tensor(t0)))
        assert abs(float(back) - t0) <= 1e-5, (t0, float(back))


def _toy_models(seed):
    """One model in both frameworks reading x, t, every condition and a
    kwarg (a condition's first entry, `static_latent` among them, so that
    zero_uncond_keys shows). It takes only correctly rounded operations
    (no reduction, whose order differs between the frameworks, and the
    softsign u / (1 + |u|) where XLA's tanh and sqrt differ from torch's
    in the last bits), so that both give it to the bit: the solvers' first
    step from t = 1 cancels terms some 1e4 times its result (alpha_T =
    0.006), which would turn a last-bit difference of the model into one
    of 1e-5 in the sample."""
    a = _draw(seed, 1, 1, 1, 4)

    def squash(mod, u):
        return u / (1.0 + mod.abs(u))

    def body(mod, x, t, cond_images, static_latent, positions, w):
        c = (cond_images[:, 0, 0, 0] + 0.5 * static_latent[:, 0, 0]
             + positions[:, 0, 0])
        return squash(mod, x * a * w + 1e-3 * t[:, None, None, None]
                      + c[:, None, None, None])

    return (lambda x, t, **kw: body(torch, x, t, **kw),
            lambda x, t, **kw: body(jnp, x, t, **kw))


def _conds(seed, B=2):
    r = np.random.default_rng(seed)
    c = dict(cond_images=r.standard_normal((B, 2, 3, 4)),
             static_latent=r.standard_normal((B, 5, 14)),
             positions=r.standard_normal((B, 5, 3)))
    u = dict(c, cond_images=np.zeros((B, 2, 3, 4)))
    f = lambda d, m: {k: m(v.astype(np.float32)) for k, v in d.items()}
    return ((f(c, torch.from_numpy), f(u, torch.from_numpy)),
            (f(c, jnp.asarray), f(u, jnp.asarray)))


def _wrapped(model_type="v", guidance_type="uncond", scales=(1.0, 1.0),
             seed=30, record=None):
    """(port model_fn, JAX model_fn, schedules) for one wrapper setting;
    `record` gets the time input of each JAX model call, on the host."""
    pns, jns = _schedules()
    pm, jm = _toy_models(seed)
    if record is not None:
        jm0 = jm

        def jm(x, t, **kw):
            jax.debug.callback(lambda v: record(float(v)), t[0], ordered=True)
            return jm0(x, t, **kw)

    (pc, pu), (jc, ju) = _conds(seed + 1)
    kw = dict(model_type=model_type, guidance_type=guidance_type,
              guidance_scale=scales[0], guidance_scale2=scales[1])
    pfn = pdpm.model_wrapper(pm, pns, model_kwargs=dict(w=0.7), condition=pc,
                             unconditional_condition=pu, **kw)
    jfn = jdpm.model_wrapper(jm, jns, model_kwargs=dict(w=0.7), condition=jc,
                             unconditional_condition=ju, **kw)
    return pfn, jfn, pns, jns


def _x(seed=40):
    return _draw(seed, 2, 3, 5, 4)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
@pytest.mark.parametrize("guidance,scales", [
    ("uncond", (2.0, 5.0)), ("classifier-free", (2.0, 5.0)),
    ("classifier-free", (1.0, 1.0))], ids=["uncond", "cfg", "cfg_1"])
def test_model_wrapper_types_match_jax(model_type, guidance, scales):
    """Each model type unguided, under dual-scale CFG (2.0 / 5.0, the first
    branch with static_latent zeroed) and classifier-free at 1.0 / 1.0 (one
    pass); the time a scalar and a [B] vector."""
    pfn, jfn, _, _ = _wrapped(model_type, guidance, scales)
    x = _x()
    for t in (0.6, np.array([0.3, 0.05], np.float32)):
        _close(pfn(torch.from_numpy(x), torch.tensor(t)),
               jfn(jnp.asarray(x), jnp.asarray(t, jnp.float32)))


@pytest.mark.parametrize("skip_type", ["time_uniform", "time_quadratic",
                                       "logSNR"])
def test_time_grids_match_jax(skip_type):
    pfn, jfn, pns, jns = _wrapped()
    got = pdpm.DPMSolver(pfn, pns).get_time_steps(skip_type, 1.0, 0.001, 9)
    want = jdpm.DPMSolver(jfn, jns).get_time_steps(skip_type, 1.0, 0.001, 9)
    assert got.dtype == want.dtype
    _close(got, want)


MULTISTEP = [("dpmsolver++", sk, 2, 12, True) for sk in
             ("time_uniform", "time_quadratic", "logSNR")] + [
    ("dpmsolver", sk, 3, 12, True) for sk in
    ("time_uniform", "time_quadratic", "logSNR")] + [
    (alg, "time_uniform", 3, 7, False) for alg in ("dpmsolver++",
                                                   "dpmsolver")]


@pytest.mark.parametrize("algorithm,skip_type,order,steps,lof", MULTISTEP)
def test_multistep_matches_jax(algorithm, skip_type, order, steps, lof):
    """Each time grid with each algorithm; from 12 steps the constant-order
    loop; at 7 steps without lower_order_final, constant order too."""
    pfn, jfn, pns, jns = _wrapped("noise")
    x = _x()
    kw = dict(steps=steps, order=order, skip_type=skip_type,
              lower_order_final=lof)
    got = pdpm.DPMSolver(pfn, pns, algorithm).sample(torch.from_numpy(x), **kw)
    want = jdpm.DPMSolver(jfn, jns, algorithm).sample(jnp.asarray(x), **kw)
    _close(got, want, TOL_STIFF if algorithm == "dpmsolver" else TOL)


SINGLESTEP = [("singlestep", o, s, "dpmsolver++") for o in (1, 2, 3)
              for s in ("time_uniform", "logSNR")] + [
    ("singlestep", 2, "time_quadratic", "dpmsolver"),
    ("singlestep", 1, "time_uniform", "dpmsolver"),
    ("singlestep_fixed", 1, "time_uniform", "dpmsolver++"),
    ("singlestep_fixed", 2, "logSNR", "dpmsolver++"),
    ("singlestep_fixed", 3, "time_quadratic", "dpmsolver++"),
    ("singlestep_fixed", 2, "time_uniform", "dpmsolver")]


@pytest.mark.parametrize("method,order,skip_type,algorithm", SINGLESTEP)
def test_singlestep_matches_jax(method, order, skip_type, algorithm):
    pfn, jfn, pns, jns = _wrapped("v", "classifier-free", (2.0, 5.0))
    x = _x()
    kw = dict(steps=8, order=order, skip_type=skip_type, method=method)
    ps = pdpm.DPMSolver(pfn, pns, algorithm)
    got = ps.sample(torch.from_numpy(x), **kw)
    want = jdpm.DPMSolver(jfn, jns, algorithm).sample(jnp.asarray(x), **kw)
    _close(got, want, TOL_STIFF if algorithm == "dpmsolver" else TOL)
    orders = (ps.get_orders_and_timesteps_for_singlestep_solver(
        8, order, skip_type, 1.0, 1.0 / pns.total_N)[1]
        if method == "singlestep" else [order] * (8 // order))
    assert ps.nfe == sum(orders)


def _jax_accepted(x, order, **kw):
    """(x, info, iterations, accepted steps) of JAX's adaptive solver, its
    model recording the time of each call through a host callback inside
    the while_loop: each iteration starts with a call at its s, which moves
    only when the step before was accepted, and the loop ends on an
    accepted step."""
    calls = []
    _, jfn, _, jns = _wrapped("v", "classifier-free", (2.0, 5.0),
                              record=calls.append)
    out, info = jdpm.DPMSolver(jfn, jns).sample(
        jnp.asarray(x), order=order, method="adaptive", return_info=True,
        **kw)
    jax.block_until_ready(out)
    per = {2: 2, 3: 4}[order]  # JAX evaluates the model at s1 twice at 3
    s = calls[::per]
    return out, info, len(s), sum(a != b for a, b in zip(s, s[1:])) + 1


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("span", ["full", "t_start_t_end"])
def test_adaptive_matches_jax(order, span):
    pfn, _, pns, _ = _wrapped("v", "classifier-free", (2.0, 5.0))
    x = _x(41)
    kw = {} if span == "full" else dict(t_start=0.7, t_end=0.02)
    ps = pdpm.DPMSolver(pfn, pns)
    got, info = ps.sample(torch.from_numpy(x), order=order, method="adaptive",
                          return_info=True, **kw)
    want, jinfo, iters, accepted = _jax_accepted(x, order, **kw)
    assert iters == int(jinfo["iters"])
    assert (info["iters"], info["accepted"]) == (iters, accepted), (
        f"accept/reject flip: port {info}, JAX {iters} iterations, "
        f"{accepted} accepted")
    assert info["rejected"] == iters - accepted
    assert info["nfe"] == int(jinfo["nfe"]) == order * iters
    assert info["syncs"] == iters < 200
    _close(got, want)


@pytest.mark.parametrize("method", ["multistep", "singlestep"])
@pytest.mark.parametrize("direction", ["span", "inverse"])
def test_sample_span_and_inverse_match_jax(method, direction):
    """sample between t_start and t_end, and inverse (data -> noise, the
    solver in reverse time)."""
    pfn, jfn, pns, jns = _wrapped("noise")
    x = _x(42)
    kw = dict(steps=6, order=2, method=method)
    ps, js = pdpm.DPMSolver(pfn, pns), jdpm.DPMSolver(jfn, jns)
    if direction == "span":
        _close(ps.sample(torch.from_numpy(x), t_start=0.8, t_end=0.05, **kw),
               js.sample(jnp.asarray(x), t_start=0.8, t_end=0.05, **kw))
    else:
        _close(ps.inverse(torch.from_numpy(x), **kw),
               js.inverse(jnp.asarray(x), **kw), TOL_STIFF)
