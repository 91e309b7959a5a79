"""Renders of the port's camera, sampler and film vocabulary on the CPU:
a render with the Sobol' sampler, Sobol' bounce dimensions and a Gaussian
filter against the JAX render of the same configuration; small twins
of the JAX package's sampler, Sobol' bounce and measurement-probe render
tests (tests/test_render.py, tests/test_sensors_meters.py); and the
progressive renderer continuing each sampler's sequence across
progressions."""
import numpy as np
import pytest

from mitsuba_path_guiding_torch.film.rfilter import FILTERS
from mitsuba_path_guiding_torch.integrators.render import SAMPLERS, RenderConfig, render
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close


@pytest.fixture(scope="module")
def cornell():
    return j_build_scene(jscenes.cornell_box()), build_scene(tscenes.cornell_box(), device="cpu")


def test_render_sobol_bounces_gaussian_matches_reference(cornell):
    """render() with the Sobol' sampler, 2 Sobol' bounces and the Gaussian
    filter against the JAX render of the same configuration, 12x12 x 3
    spp: pixels within rtol 1e-3 on >= 97% (a path moved by an FMA
    contraction spreads over the filter's 16 pixels) and means within
    0.5%."""
    jsc, sc = cornell
    cfg = dict(width=12, height=12, spp=3, max_depth=3, seed=4, sampler="sobol",
               qmc_bounces=2, filter_name="gaussian")
    want = np.asarray(jrender.render(jsc, jrender.RenderConfig(**cfg)))
    got = render(sc, RenderConfig(**cfg)).numpy()
    assert frac_close(got, want, rtol=1e-3) >= 0.97
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=5e-3)


# ---------------------------------------------------------------------------
# twins of the JAX package's render tests, at small sizes
# ---------------------------------------------------------------------------

SMALL = RenderConfig(width=16, height=16, spp=12, max_depth=3)


@pytest.fixture(scope="module")
def cornell_ref(cornell):
    """The port's 16x16 Cornell box at 192 spp, depth 3."""
    return render(cornell[1], SMALL._replace(spp=192, seed=17)).numpy()


def test_sampler_families_render(cornell, cornell_ref):
    """Every sampler, each with another filter, gives a finite image whose
    mean is within 12% of the 192-spp independent one
    (tests/test_render.py's bar)."""
    _, sc = cornell
    ref = float(cornell_ref.mean())
    for smp, filt in zip(SAMPLERS, sorted(FILTERS)):
        img = render(sc, SMALL._replace(spp=16, seed=2, sampler=smp, filter_name=filt)).numpy()
        assert np.isfinite(img).all(), smp
        assert abs(img.mean() / ref - 1.0) < 0.12, (smp, filt, img.mean(), ref)


def test_qmc_bounce_dims_reduce_variance(cornell, cornell_ref):
    """Sobol' camera and bounce dimensions cut the MSE at equal spp by at
    least 25% (summed over seeds 1-3, 16x16 x 12 spp against 192 spp),
    without bias (means within 0.01)."""
    _, sc = cornell
    base, ref = SMALL, cornell_ref
    mse_ind = mse_qmc = 0.0
    means = []
    for seed in (1, 2, 3):
        b = base._replace(seed=seed)
        mse_ind += np.mean((render(sc, b).numpy() - ref) ** 2)
        q = render(sc, b._replace(sampler="sobol", qmc_bounces=2)).numpy()
        mse_qmc += np.mean((q - ref) ** 2)
        means.append(q.mean())
    assert mse_qmc < 0.75 * mse_ind, (mse_qmc, mse_ind)
    assert abs(np.mean(means) - ref.mean()) < 0.01


def meter_scene(stype):
    """A probe at the origin in a constant environment of radiance 2; the
    far sphere never blocks it."""
    return {"sensor": {"type": stype, "to_world": tscenes.look_at([0, 0, 0], [0, 0, 1])},
            "shapes": [{"type": "sphere", "center": [0, 100, 0], "radius": 0.5,
                        "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3}}],
            "emitters": [{"type": "constant", "radiance": [2.0, 2.0, 2.0]}]}


@pytest.mark.parametrize("stype,expect", [("radiancemeter", 2.0),
                                          ("irradiancemeter", np.pi * 2.0),
                                          ("fluencemeter", 4.0 * np.pi * 2.0)])
def test_measurement_sensors_constant_env(stype, expect):
    """L, pi L and 4 pi L within 5%."""
    img = render(build_scene(meter_scene(stype), device="cpu"),
                 RenderConfig(width=4, height=4, spp=64, max_depth=2, seed=1)).numpy()
    assert np.isfinite(img).all()
    assert abs(img.mean() / expect - 1.0) < 0.05, (stype, img.mean(), expect)


@pytest.mark.parametrize("sampler,filt", list(zip(SAMPLERS, sorted(FILTERS))))
def test_progressive_keeps_the_sample_index(cornell, sampler, filt):
    """An unguided progressive render of 2 progressions of 2 spp continues
    each pixel's sequence across progressions: it equals render() at 4 spp
    with the same sampler and filter (rtol 1e-6)."""
    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )

    _, sc = cornell
    cfg = RenderConfig(width=8, height=8, spp=4, max_depth=3, seed=3, sampler=sampler,
                       filter_name=filt)
    prog = ProgressiveRenderer(sc, ProgressiveConfig(render=cfg, samples_per_progression=2,
                                                     n_progressions=2, guiding=False)).render()
    np.testing.assert_allclose(prog.numpy(), render(sc, cfg).numpy(), rtol=1e-6, atol=1e-7)
