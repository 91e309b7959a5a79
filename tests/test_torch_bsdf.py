"""The port's rough conductor (GGX, conductor Fresnel) against the JAX
package's on the CPU: eval, pdf, sample and albedo on 4096 lanes of
numpy-made directions and uniforms, at alpha 0.08 (door_room's) and 0.3,
with door_room's complex IOR and a named preset."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.models import bsdf
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.types import BSDFType
from mitsuba_path_guiding_tpu.models import bsdf as jbsdf
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close

N = 4096
TYPES = (BSDFType.DIFFUSE, BSDFType.ROUGH_CONDUCTOR)
# XLA contracts the multiply-adds of its dot products on the CPU, an ulp
# here and there; near the mirror direction the GGX lobe amplifies that by
# about 1/alpha^2 (150 at alpha 0.08), hence the wider tolerance there
RTOL = {0.08: 1e-4, 0.3: 1e-5}


def _desc(alpha):
    glossy = {"type": "roughconductor", "alpha": alpha, "eta": [0.2, 0.92, 1.1],
              "k": [3.9, 2.45, 2.14]}
    return {"shapes": [
        {"type": "rectangle", "bsdf": glossy},
        {"type": "rectangle", "bsdf": {"type": "roughconductor", "alpha": alpha,
                                       "material": "Au"}},
        {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.6, 0.5]},
         "emitter": {"radiance": [1.0, 1.0, 1.0]}},
    ]}


def _dirs(rs, n, upper):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if upper:  # most lanes above the surface, some below (two-sided flip)
        d[: n * 7 // 8, 2] = np.abs(d[: n * 7 // 8, 2])
    return d


@pytest.fixture(scope="module", params=[0.08, 0.3])
def lanes(request):
    desc = _desc(request.param)
    mats = build_scene(desc, device="cpu").mats
    jmats = j_build_scene(desc).mats
    rs = np.random.default_rng(int(request.param * 100))
    mid = rs.integers(0, 3, N).astype(np.int32)
    wi, wo = _dirs(rs, N, True), _dirs(rs, N, True)
    # a third of the lanes look at the mirror direction, where the lobe is
    wo[::3] = wi[::3] * np.float32([-1, -1, 1]) + rs.normal(0, 0.05, (len(wo[::3]), 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = rs.random((N, 3)).astype(np.float32)
    return mats, jmats, mid, wi, wo.astype(np.float32), u, RTOL[request.param]


def test_scene_rows_match(lanes):
    mats, jmats, *_ = lanes
    np.testing.assert_array_equal(mats.packed.numpy(), np.asarray(jmats.packed))


def test_eval_pdf_matches(lanes):
    mats, jmats, mid, wi, wo, _, rtol = lanes
    f, pdf = bsdf.eval_pdf(mats, torch.from_numpy(mid), torch.from_numpy(wi),
                           torch.from_numpy(wo), types=TYPES)
    fj, pdfj = jbsdf.eval_pdf(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(wo),
                              types=TYPES)
    assert np.asarray(pdfj)[mid < 2].max() > 1.0  # the glossy lobe is hit
    assert frac_close(f.numpy(), np.asarray(fj), rtol=rtol) >= 0.999
    assert frac_close(pdf.numpy(), np.asarray(pdfj), rtol=rtol) >= 0.999


def test_sample_matches(lanes):
    mats, jmats, mid, wi, _, u, rtol = lanes
    s = bsdf.sample(mats, torch.from_numpy(mid), torch.from_numpy(wi), torch.from_numpy(u),
                    types=TYPES)
    sj = jbsdf.sample(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(u), types=TYPES)
    for a, b in zip(s, sj):
        assert frac_close(a.numpy(), np.asarray(b), rtol=rtol) >= 0.999
    assert (s.pdf.numpy()[mid < 2] > 0).mean() > 0.5


def test_albedo_matches(lanes):
    mats, jmats, mid, *_ = lanes
    np.testing.assert_array_equal(bsdf.albedo(mats, torch.from_numpy(mid)).numpy(),
                                  np.asarray(jbsdf.albedo(jmats, jnp.asarray(mid))))
