"""The JAX package's public surface in the port.

An AST guard reads both packages' sources (no import of either): every
public top-level name of each JAX module, every parameter and default of
each public function, method and NamedTuple, and every command-line flag
must have its counterpart at the same path in the port, or an entry in
``SURFACE_TABLE`` that says why not (a rename, an inlining, a TPU-only
knob, a default the port departs from).  A name added to a JAX module
without a counterpart fails the guard; so does an entry that no longer
names a gap.

The rest holds the functions, parameters and configuration fields ported
last against the JAX package on the CPU, from numpy seeds: the vector,
colour, vMF, warp and Beckmann helpers on 4096 lanes, ``pad_to``,
``reinhard_tonemap(burn=)``, ``StatsRegistry.reset``,
``shadow_transmittance(max_hits=)``, ``render_tiled(render_band=)``,
``RenderConfig.use_bvh`` and ``integrator``, and the emitter kinds that the
port's samplers take by default.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_path_guiding_torch as tpkg
from mitsuba_path_guiding_torch.accel import traverse as ttraverse
from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
from mitsuba_path_guiding_torch.core import math as tmath
from mitsuba_path_guiding_torch.core import spectrum as tspectrum
from mitsuba_path_guiding_torch.core import vmf as tvmf
from mitsuba_path_guiding_torch.core import warp as twarp
from mitsuba_path_guiding_torch.film import tiled as ttiled
from mitsuba_path_guiding_torch.film.exr import read_exr_rgb
from mitsuba_path_guiding_torch.integrators import erpt as terpt
from mitsuba_path_guiding_torch.integrators import irrcache as tirrcache
from mitsuba_path_guiding_torch.integrators import path as tpath
from mitsuba_path_guiding_torch.integrators import pssmlt as tpssmlt
from mitsuba_path_guiding_torch.integrators import ptracer as tptracer
from mitsuba_path_guiding_torch.integrators import render as trender
from mitsuba_path_guiding_torch.integrators import sppm as tsppm
from mitsuba_path_guiding_torch.integrators import subsurface as tsubsurface
from mitsuba_path_guiding_torch.integrators import vpl as tvpl
from mitsuba_path_guiding_torch.integrators.path import trace as t_trace
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.models import bsdf as tbsdf
from mitsuba_path_guiding_torch.models import emitter as temitter
from mitsuba_path_guiding_torch.models import microfacet as tmicro
from mitsuba_path_guiding_torch.parallel import mesh as tmesh
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene import types as ttypes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.types import EmitterKind
from mitsuba_path_guiding_torch.utils import stats as tstats
import mitsuba_path_guiding_tpu as jpkg
from mitsuba_path_guiding_tpu.accel import traverse as jtraverse
from mitsuba_path_guiding_tpu.core import math as jmath
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.core import spectrum as jspectrum
from mitsuba_path_guiding_tpu.core import vmf as jvmf
from mitsuba_path_guiding_tpu.core import warp as jwarp
from mitsuba_path_guiding_tpu.film import tiled as jtiled
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models import emitter as jemitter
from mitsuba_path_guiding_tpu.models import microfacet as jmicro
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene import types as jtypes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.utils import stats as jstats
from test_torch_emitters import KINDS as EMITTER_KINDS
from test_torch_emitters import _desc as emitter_desc
from torch_port_parity import frac_close, t

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "mitsuba_path_guiding_tpu"
PORT_PKG = ROOT / "mitsuba_path_guiding_torch"
PORT_NAME = "mitsuba_path_guiding_torch"
# JAX modules whose port has another file name
MODULE_MAP = {"ops/gather_pallas.py": "ops/gather.py",
              "ops/intersect_pallas.py": "ops/intersect_tiled.py"}
REQUIRED = "<required>"


# ---------------------------------------------------------------------------
# the surface of a module, read from its source


def _params(fn: ast.FunctionDef, method: bool = False) -> dict:
    """{parameter: default source or REQUIRED}; ``*args`` and ``**kw`` as
    ``*name`` and ``**name``; a method's first parameter left out."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(pos, defaults))
    decorators = {ast.unparse(d) for d in fn.decorator_list}
    if method and "staticmethod" not in decorators and pairs:
        pairs = pairs[1:]
    pairs += list(zip(a.kwonlyargs, a.kw_defaults))
    out = {p.arg: REQUIRED if d is None else ast.unparse(d) for p, d in pairs}
    if a.vararg:
        out["*" + a.vararg.arg] = REQUIRED
    if a.kwarg:
        out["**" + a.kwarg.arg] = REQUIRED
    return out


def _top_level(body):
    """Statements of a module's top level, through ``if`` and ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body)
            for h in node.handlers:
                yield from _top_level(h.body)
            yield from _top_level(node.orelse)
            yield from _top_level(node.finalbody)
        else:
            yield node


def _class_members(cls: ast.ClassDef) -> dict:
    """Fields {name: default or REQUIRED} and public methods {name: params}
    of a class; a class with annotated fields (a NamedTuple) and no
    ``__init__`` gets one taking its fields."""
    members, fields = {}, {}
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if node.target.id.startswith("_"):
                continue
            fields[node.target.id] = REQUIRED if node.value is None else ast.unparse(node.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_") or node.name == "__init__":
                members[node.name] = ("def", _params(node, method=True))
    for name, default in fields.items():
        members[name] = ("field", default)
    if fields and "__init__" not in members:
        members["__init__"] = ("def", dict(fields))
    return members


def module_surface(src: str, with_imports: bool) -> tuple:
    """({public name: (kind, detail)}, {name: value source}, CLI flags).

    kind is "def" (detail: params), "class" (detail: members), "var"
    (detail: the value's source), or, with ``with_imports``, "import"
    (detail: (module, name))."""
    tree = ast.parse(src)
    names, values = {}, {}
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef):
            names[node.name] = ("class", _class_members(node))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                for e in ast.walk(tgt):
                    if isinstance(e, ast.Name):
                        src_v = None if node.value is None else ast.unparse(node.value)
                        names[e.id] = ("var", src_v)
                        values[e.id] = src_v
        elif with_imports and isinstance(node, ast.ImportFrom):
            for al in node.names:
                names[al.asname or al.name] = ("import", (node.module or "", al.name))
        elif with_imports and isinstance(node, ast.Import):
            for al in node.names:
                names[al.asname or al.name.split(".")[0]] = ("import", (al.name, None))
    flags = set()
    for c in ast.walk(tree):
        if isinstance(c, ast.Call) and getattr(c.func, "attr", None) == "add_argument":
            flags |= {a.value for a in c.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)
                      and a.value.startswith("-")}
    public = {k: v for k, v in names.items() if not k.startswith("_") or k == "__version__"}
    return public, values, flags


class PortSide:
    """The port's modules, parsed on demand, with imports and aliases
    followed to the definition they name."""

    def __init__(self, root: pathlib.Path, package: str, sources=None):
        self.root, self.package = root, package
        self.sources = sources or {}
        self._cache = {}

    def surface(self, rel: str):
        if rel not in self._cache:
            src = self.sources.get(rel)
            if src is None:
                path = self.root / rel
                src = path.read_text() if path.exists() else None
            self._cache[rel] = None if src is None else module_surface(src, with_imports=True)
        return self._cache[rel]

    def _module_rel(self, module: str):
        if not module.startswith(self.package):
            return None
        parts = module.split(".")[1:]
        for rel in ("/".join(parts) + ".py", "/".join(parts + ["__init__.py"])):
            if rel in self.sources or (self.root / rel).exists():
                return rel
        return None

    def resolve(self, rel: str, name: str, depth: int = 0):
        """(kind, detail, rel) of ``name`` in module ``rel``: imports of the
        port's own modules and ``alias = name`` assignments followed."""
        surf = self.surface(rel)
        if surf is None or depth > 6:
            return None
        public, values, _ = surf
        entry = public.get(name)
        if entry is None and name in values:
            entry = ("var", values[name])
        if entry is None:
            return None
        kind, detail = entry
        if kind == "import":
            module, target = detail
            sub = self._module_rel(module) if target is not None else None
            if sub is not None:
                found = self.resolve(sub, target, depth + 1)
                if found is not None:
                    return found
                sub_mod = self._module_rel(f"{module}.{target}")
                if sub_mod is not None:
                    return ("module", None, sub_mod)
            return ("import", detail, rel)
        if kind == "var" and detail and detail.isidentifier() and detail != name:
            found = self.resolve(rel, detail, depth + 1)
            if found is not None and found[0] in ("def", "class"):
                return found
        return (kind, detail, rel)

    def constant(self, rel: str, text: str) -> str:
        """A default's source with a module constant's name replaced by its
        value's source."""
        if text.isidentifier():
            found = self.resolve(rel, text)
            if found is not None and found[0] == "var" and found[1] is not None:
                return found[1]
        return text


def _same_default(a: str, b: str) -> bool:
    if a == b:
        return True
    try:
        return eval(a, {"__builtins__": {}}) == eval(b, {"__builtins__": {}})  # noqa: S307
    except Exception:
        return False


def _compare_params(key: str, jparams: dict, tparams: dict, port: PortSide, trel: str, jvals):
    out = []
    for p, jd in jparams.items():
        if p not in tparams:
            out.append(f"{key}({p})")
            continue
        td = tparams[p]
        if jd == td or jd == REQUIRED:  # a default where JAX has none breaks no call
            continue
        if td == REQUIRED:
            out.append(f"{key}({p}={jd})")
            continue
        jv = jvals.get(jd, jd) if jd.isidentifier() else jd
        if not (_same_default(jd, port.constant(trel, td))
                or _same_default(jv or jd, port.constant(trel, td))):
            out.append(f"{key}({p}={jd})")
    return out


def surface_gaps(rel: str, jax_src: str, port: PortSide) -> list:
    """The gaps of JAX module ``rel`` in the port: missing names
    (``name``), parameters (``f(p)``, ``Class.m(p)``), defaults that
    differ (``f(p=jax default)``), class members (``Class.m``) and
    command-line flags (``--flag``)."""
    trel = MODULE_MAP.get(rel, rel)
    jpublic, jvals, jflags = module_surface(jax_src, with_imports=rel.endswith("__init__.py"))
    tsurf = port.surface(trel)
    if tsurf is None:
        return [f"<module {trel}>"]
    gaps = [f for f in sorted(jflags - tsurf[2])]
    for name, (kind, detail) in sorted(jpublic.items()):
        found = port.resolve(trel, name)
        if found is None:
            gaps.append(name)
            continue
        tkind, tdetail, where = found
        if kind == "def" and tkind == "def":
            gaps += _compare_params(name, detail, tdetail, port, where, jvals)
        elif kind == "class" and tkind == "class":
            for m, (mkind, mdetail) in sorted(detail.items()):
                tm = tdetail.get(m)
                if tm is None:
                    gaps.append(f"{name}.{m}")
                elif mkind == "def" and tm[0] == "def":
                    key = name if m == "__init__" else f"{name}.{m}"
                    gaps += _compare_params(key, mdetail, tm[1], port, where, jvals)
                elif mkind == "field" and tm[0] == "field" and mdetail != tm[1]:
                    if not _same_default(mdetail, port.constant(where, tm[1])):
                        gaps.append(f"{name}.{m}={mdetail}")
    return gaps


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


# ---------------------------------------------------------------------------
# what the port leaves out or changes on purpose, each with its reason

_TPU_INTERPRET = "Pallas's interpret mode; the port's CPU path is the kernel's plain version"
_TPU_TILE = "a TPU tiling; each CUDA kernel has its own launch geometry"
_USE_BVH = ("the port routes by ``accel`` and the scene's size (``use_bvh`` True or "
            "False chooses the BVH or the dense route as in JAX)")
_KINDS = ("the port's default kinds include ENVMAP; JAX's ALL_KINDS leaves it out and "
          "drops an envmap's light (ROADMAP Queue 3, test_default_emitter_kinds_*)")
_TYPES = ("PORTED_TYPES, ALL_TYPES without TWO_SIDED, a build-time flag no row holds; "
          "the same dispatch (test_all_types_trace_as_ported_types)")
_FUSED_TABLES = "the CUDA kernel's table layout (built by build_fused_tables only)"

SURFACE_TABLE = {
    "accel/blocks.py": {
        "SB_TRIS": "inlined: SB_BLOCKS * BLOCK_TRIS where the tables are cut",
    },
    "accel/traverse.py": {
        "shadow_transmittance(bvh)": "renamed: the route's closest-hit query ``intersect`` "
                                     "takes bvh and use_bvh's place",
        "shadow_transmittance(use_bvh)": "renamed: the route's query ``intersect``",
        "intersect_pairs_full(fb_shift=4)": "None re-traces every unproven ray; 4 is the "
                                            "reference's cap (ROADMAP Queue 3)",
        "occluded_pairs_full(fb_shift=4)": "None re-traces every unproven ray (ROADMAP Queue 3)",
    },
    "film/denoise.py": {
        "denoise_with_aux(img_np)": "renamed ``img`` (a tensor or an array)",
    },
    "film/neural_denoise.py": {
        "init_params(key)": "renamed ``generator``: a torch.Generator takes the PRNG key's place",
    },
    "guiding/fit.py": {
        "fit_from_records(psum_axis)": "renamed ``mesh``: torch.distributed's merge",
    },
    "guiding/sampler.py": {
        "make_guide_fn(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/bdpt.py": {
        "trace_bdpt(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/mlt.py": {
        "INF": "the port's MLT takes integrators.path.INFD",
    },
    "integrators/motion.py": {
        "render_motion_blur(guide)": "unread by the reference's render_motion_blur",
    },
    "integrators/path.py": {
        "trace(use_bvh=True)": "False: the port's ``accel``='auto' picks the route by the "
                               "scene (tiled kernel, BVH or pair route)",
        "trace(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "trace(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/ptracer.py": {
        "trace_light(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "trace_light(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/render.py": {
        "RenderConfig.samples_per_pass": "nothing in the JAX package reads it",
        "RenderConfig(samples_per_pass)": "nothing in the JAX package reads it",
    },
    "integrators/sppm.py": {
        "camera_pass(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "camera_pass(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
        "photon_pass(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "photon_pass(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/volpath.py": {
        "trace_vol(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "trace_vol(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "integrators/volphoton.py": {
        "volume_photon_pass(em_kinds=em_mod.ALL_KINDS)": _KINDS,
    },
    "integrators/vpl.py": {
        "generate_vpls(em_kinds=em_mod.ALL_KINDS)": _KINDS,
        "generate_vpls(mat_types=bsdf_mod.ALL_TYPES)": _TYPES,
    },
    "models/bsdf.py": {
        "cloth_spec_raw(xp=jnp)": "the array module: torch's, not jax.numpy",
        "eval_pdf_raw(types=ALL_TYPES)": _TYPES,
        "sample_raw(types=ALL_TYPES)": _TYPES,
    },
    "models/emitter.py": {
        "sample_direct(kinds=ALL_KINDS)": _KINDS,
        "sample_ray(kinds=ALL_KINDS)": _KINDS,
    },
    "models/envmap.py": {
        "jax_vmap_searchsorted": "a jax.vmap stand-in for a per-row searchsorted; the port "
                                 "calls torch.searchsorted",
    },
    "ops/fused_path.py": {
        "TILE": _TPU_TILE,
        "FusedTables(tri_cols)": _FUSED_TABLES,
        "FusedTables(tri_shade)": _FUSED_TABLES,
        "FusedTables(em_tab)": _FUSED_TABLES,
        "FusedTables(mat_tab)": _FUSED_TABLES,
        "fused_supported(record_paths)": "a gate no caller sets",
        "fused_supported(levels)": "a gate no caller sets",
        "trace_fused(interpret)": _TPU_INTERPRET,
    },
    "ops/gather_pallas.py": {
        "LANE_TILE": _TPU_TILE,
        "MAX_ONEHOT_ROWS": "the TPU's one-hot matmul gather; the CUDA gather reads rows",
    },
    "ops/intersect_blocklist.py": {
        "DEBUG_COUNTERS": "the Pallas kernel's debug rows",
        "candidate_superblocks(k=MAX_CAND)": "required: its callers pass their width",
        "intersect_blocklist_raw(interpret)": _TPU_INTERPRET,
        "occluded_blocklist_raw(interpret)": _TPU_INTERPRET,
    },
    "ops/intersect_pairs.py": {
        "intersect_pairs_raw(use_pallas)": "the TPU's Pallas or XLA tiles: the wrapper "
                                           "launches the CUDA kernel on the card",
    },
    "ops/intersect_pallas.py": {
        "RAY_TILE": _TPU_TILE,
        "intersect_tiled(tri_pack)": "renamed: the packed triangles are the first argument",
        "intersect_tiled(interpret)": _TPU_INTERPRET,
    },
    "ops/intersect_twolevel.py": {
        "intersect_blocks(interpret)": _TPU_INTERPRET,
    },
    "parallel/mesh.py": {
        "make_device_mesh(devices)": "renamed ``device`` and ``group`` (torch.distributed)",
    },
}


@pytest.fixture(scope="module")
def port():
    return PortSide(PORT_PKG, PORT_NAME)


@pytest.mark.parametrize("rel", jax_modules())
def test_public_surface_has_counterparts(rel, port):
    """Every public name, parameter, default and flag of the JAX module is
    in the port or in SURFACE_TABLE, and every table entry is a gap."""
    gaps = set(surface_gaps(rel, (JAX_PKG / rel).read_text(), port))
    table = SURFACE_TABLE.get(rel, {})
    assert sorted(gaps - set(table)) == [], "JAX names or parameters without a counterpart"
    assert sorted(set(table) - gaps) == [], "table entries that no longer name a gap"
    assert all(reason.strip() for reason in table.values())


def test_surface_table_names_jax_modules():
    assert set(SURFACE_TABLE) <= set(jax_modules())


def test_guard_fails_on_a_new_name():
    """A JAX module with one more public function, parameter, default,
    NamedTuple field or flag than its port gives that gap and no other."""
    port_src = '''
K = 4
class Cfg(NamedTuple):
    a: int = K
def f(x, y=1.0, *, z=None):
    return x
def main():
    argparse.ArgumentParser().add_argument("--out")
'''
    jax_src = '''
class Cfg(NamedTuple):
    a: int = 4
    b: float = 0.5
def f(x, y=2.0, *, z=None, w=3):
    return x
def g():
    pass
NEW = 1
def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    p.add_argument("-q", "--quiet")
'''
    port = PortSide(PORT_PKG, PORT_NAME, sources={"x.py": port_src})
    assert sorted(surface_gaps("x.py", jax_src, port)) == sorted(
        ["-q", "--quiet", "Cfg.b", "Cfg(b)", "f(y=2.0)", "f(w)", "g", "NEW"])
    assert surface_gaps("x.py", port_src, port) == []


# ---------------------------------------------------------------------------
# the functions ported last against the JAX package, 4096 lanes

N = 4096


def _lanes(seed):
    """Inputs of every shape the helpers take, from one numpy seed: unit
    vectors (a tenth of them within 1e-4 of the horizon, where tan_theta
    and the Beckmann terms are steepest), uniforms, angles, vMF
    parameters, roughness and colours."""
    rs = np.random.default_rng(seed)
    v = rs.normal(size=(N, 3))
    v[: N // 10, 2] = rs.uniform(-1e-4, 1e-4, N // 10)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rs.normal(size=(N, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    f = np.float32
    return {
        "v": v.astype(f), "w": w.astype(f), "u": rs.random((N, 2)).astype(f),
        "t": rs.random(N).astype(f), "theta": (rs.random(N) * np.pi).astype(f),
        "phi": (rs.random(N) * 2 * np.pi).astype(f),
        "kappa": np.exp(rs.uniform(np.log(1e-4), np.log(1e4), N)).astype(f),
        "kappa2": np.exp(rs.uniform(np.log(1e-4), np.log(1e4), N)).astype(f),
        "alpha": rs.uniform(0.02, 1.0, N).astype(f),
        "rgb": (rs.random((N, 3)) * 4.0).astype(f), "srgb": rs.random((N, 3)).astype(f),
        "p0": (rs.random((N, 3)) * 2.0 - 2.0).astype(f),
        "e1": (rs.random((N, 3)) * 4.0).astype(f), "e2": (rs.random((N, 3)) * 4.0).astype(f),
    }


def _coth_ulps(x):
    """4 float32 ulp of coth(kappa): kappa_to_mean_cosine subtracts 1/kappa
    from it, so for small kappa both packages keep only that much."""
    k = np.maximum(x["kappa"].astype(np.float64), 1e-4)
    return 4.0 * np.finfo(np.float32).eps / np.tanh(k)


# (name, function of a module and the lanes, relative tolerance, absolute
# tolerance or a function of the lanes giving it lane by lane): float32
# functions of the same formula; the transcendental ones (sin, cos, exp,
# log, atan2, acos, tanh, pow) round differently in XLA's and torch's CPU
# code, within a few ulp
PARITY = [
    ("sin_theta", lambda m, x: m.math.sin_theta(x["v"]), 1e-6, 1e-6),
    ("tan_theta", lambda m, x: m.math.tan_theta(x["v"]), 1e-6, 1e-6),
    ("sphdir", lambda m, x: m.math.sphdir(x["theta"], x["phi"]), 1e-5, 1e-6),
    ("face_forward", lambda m, x: m.math.face_forward(x["v"], x["w"]), 0.0, 0.0),
    ("spherical_phi_theta", lambda m, x: m.stack(m.math.spherical_phi_theta(x["v"])), 1e-5,
     1e-6),
    ("reflect", lambda m, x: m.math.reflect(x["v"], x["w"]), 1e-5, 1e-6),
    ("lerp", lambda m, x: m.math.lerp(x["v"], x["w"], x["t"][:, None]), 1e-6, 1e-6),
    ("rgb_to_xyz", lambda m, x: m.spectrum.rgb_to_xyz(x["rgb"]), 1e-5, 1e-6),
    ("xyz_to_rgb", lambda m, x: m.spectrum.xyz_to_rgb(x["rgb"]), 1e-5, 1e-6),
    ("srgb_encode", lambda m, x: m.spectrum.srgb_encode(x["srgb"]), 1e-5, 1e-6),
    ("srgb_decode", lambda m, x: m.spectrum.srgb_decode(x["srgb"]), 1e-5, 1e-6),
    ("max_component", lambda m, x: m.spectrum.max_component(x["rgb"]), 0.0, 0.0),
    ("kappa_to_mean_cosine", lambda m, x: m.vmf.kappa_to_mean_cosine(x["kappa"]), 1e-5,
     _coth_ulps),
    ("vmf_product_kappa_mu", lambda m, x: m.stack(m.vmf.vmf_product_kappa_mu(
        x["v"], x["kappa"], x["w"], x["kappa2"])), 1e-5, 1e-6),
    ("square_to_std_normal", lambda m, x: m.warp.square_to_std_normal(x["u"]), 1e-5, 1e-6),
    ("interval_to_tent", lambda m, x: m.warp.interval_to_tent(x["t"]), 1e-6, 1e-6),
    ("beckmann_d", lambda m, x: m.micro.beckmann_d(x["v"], x["alpha"]), 1e-5, 1e-6),
    ("beckmann_g1", lambda m, x: m.micro.beckmann_g1(x["v"], x["alpha"]), 1e-6, 1e-6),
]


class _Side:
    """One package's modules and its way to make arrays."""

    def __init__(self, torch_side: bool):
        self.torch_side = torch_side
        if torch_side:
            self.math, self.spectrum, self.vmf, self.warp = tmath, tspectrum, tvmf, twarp
            self.micro, self.traverse = tmicro, ttraverse
        else:
            self.math, self.spectrum, self.vmf, self.warp = jmath, jspectrum, jvmf, jwarp
            self.micro, self.traverse = jmicro, jtraverse

    def lanes(self, x):
        arr = torch.from_numpy if self.torch_side else jnp.asarray
        return {k: arr(np.ascontiguousarray(v)) for k, v in x.items()}

    def stack(self, parts):
        """A tuple of per-lane results as one (N, k) float array."""
        cols = [(p.reshape(N, -1) if p.ndim > 1 else p[:, None]) for p in parts]
        if self.torch_side:
            return torch.cat([c.to(torch.float32) for c in cols], dim=-1)
        return jnp.concatenate([c.astype(jnp.float32) for c in cols], axis=-1)


@pytest.mark.parametrize("name,fn,rtol,atol", PARITY, ids=[p[0] for p in PARITY])
def test_helper_matches_reference(name, fn, rtol, atol):
    """Each helper on 4096 lanes: every component within ``rtol`` and
    ``atol`` of the JAX package's on every lane; 0 and 0 mean bit-equal."""
    x = _lanes(len(name))
    tside, jside = _Side(True), _Side(False)
    got = fn(tside, tside.lanes(x)).numpy()
    want = np.asarray(fn(jside, jside.lanes(x)))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        atol = atol(x).reshape(N, *([1] * (want.ndim - 1))) if callable(atol) else atol
        assert (np.abs(got - want) <= atol + rtol * np.abs(want)).all()
    assert np.isfinite(want).mean() > 0.99


def test_moeller_trumbore_matches_reference():
    """The hit masks agree on >= 99.9% of 4096 random rays and triangles
    (XLA contracts the dot products into FMAs), and t, u, v on the rays
    both count as hits within 1e-5 (rtol and atol)."""
    x = _lanes(3)
    args = lambda a: (a["v"], a["w"], a["p0"], a["e1"], a["e2"], 1e-4, 1e30)  # noqa: E731
    got = [a.numpy() for a in ttraverse.moeller_trumbore(*args(_Side(True).lanes(x)))]
    want = [np.asarray(a) for a in jtraverse.moeller_trumbore(*args(_Side(False).lanes(x)))]
    assert 0.05 < want[3].mean() < 0.95
    assert (got[3] == want[3]).mean() >= 0.999
    both = got[3] & want[3]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[both], w[both], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,n,fill", [((5, 3), 8, 0), ((7,), 7, -1), ((2, 2, 2), 3, 1.5)])
def test_pad_to_equals_reference(shape, n, fill):
    arr = np.random.default_rng(1).random(shape).astype(np.float32)
    got, want = ttypes.pad_to(arr, n, fill), jtypes.pad_to(arr, n, fill)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _tonemap_today(rgb, key=0.18):
    """The port's tonemap before ``burn``: L / (1 + L)."""
    lum = tspectrum.luminance(rgb)
    log_avg = torch.exp(torch.mean(torch.log(torch.clamp_min(lum, 1e-6))))
    scaled = rgb * (key / torch.clamp_min(log_avg, 1e-12))
    lw = tspectrum.luminance(scaled)
    return scaled * ((lw / (1.0 + lw)) / torch.clamp_min(lw, 1e-12))[..., None]


@pytest.mark.parametrize("burn", [0.0, 1.0])
def test_reinhard_tonemap_burn(burn):
    """burn 0 stays bit-equal to the port's earlier tonemap; burn 0 and 1
    within 1e-5 of JAX's (an HDR image of 64x64 with a few bright
    texels)."""
    rs = np.random.default_rng(11)
    img = (rs.random((64, 64, 3)) ** 3 * 2.0).astype(np.float32)
    img[3, 7] = 60.0
    got = tspectrum.reinhard_tonemap(torch.from_numpy(img), burn=burn)
    want = np.asarray(jspectrum.reinhard_tonemap(jnp.asarray(img), burn=burn))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    plain = _tonemap_today(torch.from_numpy(img))
    if burn == 0.0:
        assert torch.equal(got, plain)
    else:
        # the white point brightens every pixel; the brightest maps to 1
        assert bool((got >= plain).all()) and not torch.equal(got, plain)
        lw = tspectrum.luminance(got)
        assert float(lw.max()) == pytest.approx(1.0, rel=1e-5)


def test_stats_registry_reset_matches_reference():
    """add, average, reset and report in both packages give the same
    counters; GLOBAL_STATS is a registry."""
    reports = []
    for mod in (tstats, jstats):
        reg = mod.StatsRegistry()
        reg.add("rays traced", 3.0e6)
        reg.average("avg path length", 4.0, 2.0)
        before = (reg.get("rays traced"), reg.get("avg path length"))
        reg.reset()
        after = (reg.get("rays traced"), reg.get("avg path length"))
        reg.add("samples", 7)
        reports.append((before, after, reg.report().splitlines()[:2]))
        assert isinstance(mod.GLOBAL_STATS, mod.StatsRegistry)
    assert reports[0] == reports[1]
    assert reports[0][0] == (3.0e6, 2.0) and reports[0][1] == (0.0, 0.0)


def test_package_handles_match_reference():
    assert tpkg.__version__ == jpkg.__version__
    assert tpkg.mmath is tmath and tpkg.spectrum is tspectrum and tpkg.warp is twarp
    from mitsuba_path_guiding_torch.core import rng as trng

    assert tpkg.rng is trng


# ---------------------------------------------------------------------------
# shadow_transmittance's march length


def _masked_box(mod):
    """Cornell with a 0.4-opacity mask on the tall box and a null short
    box (tests/test_torch_shading_path.py's scene)."""
    sc = mod.cornell_box()
    sc["shapes"][5]["bsdf"] = {"type": "mask", "opacity": 0.4, "bsdf": {"type": "diffuse"}}
    sc["shapes"][4]["bsdf"] = {"type": "null"}
    return sc


@pytest.fixture(scope="module")
def masked_box():
    return j_build_scene(_masked_box(jscenes)), build_scene(_masked_box(tscenes), device="cpu")


@pytest.mark.parametrize("max_hits", [1, 2, 4])
def test_shadow_transmittance_max_hits(masked_box, max_hits):
    """4096 rays from points in the box, a third unbounded, a third short,
    a third dead, through the tiled route's query: equal to JAX's march of
    ``max_hits`` hits through its dense oracle; one hit can only pass 1,
    0.6 or 0, and a longer march keeps or lowers each ray's value."""
    jscene, scene = masked_box
    rs = np.random.default_rng(4)
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    o = (lo + (hi - lo) * rs.random((N, 3))).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sel = rs.integers(0, 3, N)
    tmax = np.where(sel == 0, 3.0e37, np.where(sel == 1, 2.0 * rs.random(N), -1.0))
    tmax = tmax.astype(np.float32)
    want = np.asarray(jtraverse.shadow_transmittance(
        jscene.geo, jscene.bvh, jscene.mats.packed, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), use_bvh=False, max_hits=max_hits))
    geo = scene.geo

    def march(k):
        return ttraverse.shadow_transmittance(
            geo, scene.mats.packed, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(tmax), lambda o_, d_, t_: intersect_pallas(geo, o_, d_, t_),
            max_hits=k).numpy()

    got = march(max_hits)
    np.testing.assert_array_equal(got, want)
    if max_hits == 1:
        assert set(np.round(want.astype(np.float64), 4).tolist()) == {0.0, 0.6, 1.0}
    else:
        shorter = march(max_hits // 2)
        assert (got <= shorter).all() and (got < shorter).any()


# ---------------------------------------------------------------------------
# the emitter kinds of a default call: the port keeps ENVMAP, the
# reference's ALL_KINDS leaves it out (ROADMAP.md Queue 3)


@pytest.fixture(scope="module")
def env_scene():
    """tests/test_torch_emitters.py's envmap scene: a plane, a small area
    light and an environment map."""
    desc = emitter_desc(EMITTER_KINDS["envmap"])
    return j_build_scene(desc), build_scene(desc, device="cpu")


def _direct_lanes():
    rs = np.random.default_rng(7)
    p = (rs.random((N, 3)) * [2.0, 1.0, 2.0] - [1.0, 0.0, 1.0]).astype(np.float32)
    return p, rs.random((N, 3)).astype(np.float32)


def _same_sample(got, want, fields, min_frac=0.999):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if g.dtype == bool or g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert frac_close(g, w, rtol=1e-5) >= min_frac, f


DIRECT_FIELDS = ("emitter_id", "is_delta", "direction", "distance", "radiance", "pdf")
RAY_FIELDS = ("valid", "o", "d", "weight", "normal", "emit_weight")


def test_default_emitter_kinds_depart_from_the_reference(env_scene):
    """The departure, measured: JAX's default sample_direct gives no
    radiance on any of 4096 lanes of the envmap scene; the port's default
    lights the lanes that picked the envmap (over 70% of them)."""
    jscene, scene = env_scene
    p, u = _direct_lanes()
    dj = jemitter.sample_direct(jscene.emitters, jscene.geo, jnp.asarray(p), jnp.asarray(u))
    dt = temitter.sample_direct(scene.emitters, scene.geo, t(p), t(u))
    env_lanes = np.asarray(jscene.emitters.kind)[dt.emitter_id.numpy()] == EmitterKind.ENVMAP
    assert env_lanes.mean() > 0.7
    assert (np.asarray(dj.radiance) == 0).all()
    assert (dt.radiance.numpy()[env_lanes].max(axis=-1) > 0).mean() > 0.99
    assert EmitterKind.ENVMAP in temitter.PORTED_KINDS
    assert temitter.ALL_KINDS == jemitter.ALL_KINDS


@pytest.mark.parametrize("side", ["port_default_is_kinds_present", "all_kinds_is_jax_default"])
def test_default_emitter_kinds_sample_direct(env_scene, side):
    """Both sides of the departure: the port's default call equals JAX's
    call with kinds_present(...), and the port called with ALL_KINDS
    equals JAX's default call, zeros included."""
    jscene, scene = env_scene
    p, u = _direct_lanes()
    if side == "port_default_is_kinds_present":
        got = temitter.sample_direct(scene.emitters, scene.geo, t(p), t(u))
        want = jemitter.sample_direct(jscene.emitters, jscene.geo, jnp.asarray(p),
                                      jnp.asarray(u),
                                      kinds=jemitter.kinds_present(jscene.emitters))
    else:
        got = temitter.sample_direct(scene.emitters, scene.geo, t(p), t(u),
                                     kinds=temitter.ALL_KINDS)
        want = jemitter.sample_direct(jscene.emitters, jscene.geo, jnp.asarray(p),
                                      jnp.asarray(u))
        assert (got.radiance.numpy() == 0).all()
    _same_sample(got, want, DIRECT_FIELDS)


@pytest.mark.parametrize("side", ["port_default_is_kinds_present", "all_kinds_is_jax_default"])
def test_default_emitter_kinds_sample_ray(env_scene, side):
    jscene, scene = env_scene
    u = np.random.default_rng(8).random((N, 5)).astype(np.float32)
    args_j = (jscene.emitters, jscene.aabb_min, jscene.aabb_max, jnp.asarray(u))
    args_t = (scene.emitters, scene.aabb_min, scene.aabb_max, t(u))
    if side == "port_default_is_kinds_present":
        got = temitter.sample_ray(*args_t)
        want = jemitter.sample_ray(*args_j, kinds=jemitter.kinds_present(jscene.emitters))
        assert np.asarray(want.valid).mean() > 0.5
    else:
        got = temitter.sample_ray(*args_t, kinds=temitter.ALL_KINDS)
        want = jemitter.sample_ray(*args_j)
        # the lanes that picked the envmap emit nothing
        assert np.asarray(want.valid).mean() < 0.5
    _same_sample(got, want, RAY_FIELDS)


@pytest.fixture(scope="module")
def env_traces(env_scene):
    """trace on a 16x16 camera wave of the envmap scene, depth 3: JAX with
    its default kinds and with kinds_present, the port with its default
    and with ALL_KINDS."""
    jscene, scene = env_scene
    pix = jnp.arange(256, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 16, 16, pix, u)
    kw = dict(max_depth=3, rr_depth=3, use_bvh=False)
    kinds = jemitter.kinds_present(jscene.emitters)
    return {
        "jax_default": j_trace(jscene, o, d, kj, **kw)[0],
        "jax_present": j_trace(jscene, o, d, kj, em_kinds=kinds, **kw)[0],
        "port_default": t_trace(scene, t(o), t(d), t(kj), **kw)[0],
        "port_all_kinds": t_trace(scene, t(o), t(d), t(kj), em_kinds=temitter.ALL_KINDS,
                                  **kw)[0],
    }


@pytest.mark.parametrize("port,jax", [("port_default", "jax_present"),
                                      ("port_all_kinds", "jax_default")])
def test_default_emitter_kinds_trace(env_traces, port, jax):
    """trace's default em_kinds: the port's default equals JAX's
    kinds_present run, the port's ALL_KINDS run JAX's default run, lane by
    lane at rtol 1e-4 on >= 99% of lanes (XLA's FMAs); the envmap lights
    the scene only in the first pair."""
    got, want = env_traces[port].numpy(), np.asarray(env_traces[jax])
    assert frac_close(got, want, rtol=1e-4) >= 0.99
    dark, lit = np.asarray(env_traces["jax_default"]), np.asarray(env_traces["jax_present"])
    assert lit.mean() > 1.5 * dark.mean()


def test_all_types_trace_as_ported_types(env_scene):
    """ALL_TYPES (with TWO_SIDED, which no material row holds) traces
    bit-equal to PORTED_TYPES."""
    jscene, scene = env_scene
    rs = np.random.default_rng(2)
    o = np.tile(np.float32([0.0, 1.0, 0.0]), (512, 1))
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    keys = t(jrng.ray_keys(jrng.base_key(1), jnp.arange(512, dtype=jnp.int32),
                           jnp.zeros(512, jnp.int32)))
    a = t_trace(scene, t(o), t(d), keys, max_depth=3, mat_types=tbsdf.ALL_TYPES)[0]
    b = t_trace(scene, t(o), t(d), keys, max_depth=3, mat_types=tbsdf.PORTED_TYPES)[0]
    assert torch.equal(a, b) and float(a.mean()) > 0.0


# ---------------------------------------------------------------------------
# render_tiled's band renderer; RenderConfig.use_bvh and integrator


RCFG = dict(width=16, height=16, spp=2, max_depth=3, rr_depth=3, seed=5)


@pytest.fixture(scope="module")
def cornell():
    return j_build_scene(jscenes.cornell_box()), build_scene(tscenes.cornell_box(), device="cpu")


def _fixed_band(xp):
    """A band renderer of fixed radiance: each sample lands at its pixel's
    centre with a colour made of its pixel and sample index."""
    f32 = (lambda a: a.astype(jnp.float32)) if xp is jnp else (lambda a: a.float())

    def band(scene, cfg, pix, sidx):
        x, y, s = f32(pix % cfg.width), f32(pix // cfg.width), f32(sidx)
        return (xp.stack([x + 0.5, y + 0.5], -1),
                xp.stack([x * 0.01 + s, y * 0.25, 0.5 + 0.0 * s], -1))
    return band


def test_render_tiled_band_renderer_matches_reference(cornell, tmp_path):
    """A caller's band renderer replaces render_wave: the port's EXR file
    (24x20, bands of 8 rows, 3 spp) equals JAX's byte for byte, and every
    pixel holds the mean of its samples' colours."""
    jscene, scene = cornell
    cfg = dict(width=24, height=20, spp=3)
    jtiled.render_tiled(jscene, jrender.RenderConfig(**cfg), str(tmp_path / "j.exr"),
                        band_rows=8, render_band=_fixed_band(jnp))
    ttiled.render_tiled(scene, trender.RenderConfig(**cfg), str(tmp_path / "t.exr"),
                        band_rows=8, render_band=_fixed_band(torch))
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    img = read_exr_rgb(str(tmp_path / "t.exr"))
    x = np.arange(24, dtype=np.float32)[None, :]
    np.testing.assert_allclose(img[..., 0], np.broadcast_to(x * 0.01 + 1.0, (20, 24)), rtol=1e-6)
    np.testing.assert_allclose(img[..., 2], 0.5, rtol=1e-6)


def test_render_tiled_default_bands_match_reference(cornell, tmp_path):
    """Without a band renderer both packages render each band by
    render_wave: Cornell 16x16 in bands of 6 rows, per pixel rtol 1e-4 on
    >= 99% of pixels (XLA's FMAs move a few paths); a band renderer that
    calls render_wave writes the same file as none."""
    jscene, scene = cornell
    jtiled.render_tiled(jscene, jrender.RenderConfig(**RCFG), str(tmp_path / "j.exr"),
                        band_rows=6)
    ttiled.render_tiled(scene, trender.RenderConfig(**RCFG), str(tmp_path / "t.exr"),
                        band_rows=6)
    ttiled.render_tiled(scene, trender.RenderConfig(**RCFG), str(tmp_path / "b.exr"),
                        band_rows=6, render_band=lambda s, c, p, i: trender.render_wave(
                            s, c, p, i)[:2])
    got, want = (read_exr_rgb(str(tmp_path / f)) for f in ("t.exr", "j.exr"))
    assert want.mean() > 0.0
    assert frac_close(got.reshape(-1, 3), want.reshape(-1, 3), rtol=1e-4) >= 0.99
    assert (tmp_path / "b.exr").read_bytes() == (tmp_path / "t.exr").read_bytes()


@pytest.mark.parametrize("field", [{"use_bvh": True}, {"use_bvh": False},
                                   {"integrator": "volpath"}], ids=lambda f: str(f))
def test_render_config_fields_match_reference(cornell, field):
    """RenderConfig(use_bvh=...) and (integrator="volpath") on Cornell
    16x16 against JAX's render: the mean within rtol 1e-4 and each pixel
    within rtol 1e-4 on >= 99% of pixels, the tolerances of the trace_vol
    twins (tests/test_torch_volpath.py)."""
    jscene, scene = cornell
    want = np.asarray(jrender.render(jscene, jrender.RenderConfig(**RCFG, **field)))
    got = trender.render(scene, trender.RenderConfig(**RCFG, **field)).numpy()
    assert want.mean() > 0.0 and np.isfinite(got).all()
    assert float(got.mean()) == pytest.approx(float(want.mean()), rel=1e-4)
    assert frac_close(got.reshape(-1, 3), want.reshape(-1, 3), rtol=1e-4) >= 0.99


# ---------------------------------------------------------------------------
# the readers of RenderConfig.use_bvh: each render entry point whose JAX
# counterpart reads it routes by it


READERS = {
    "render": lambda s, c: trender.render(s, c),
    "render_volpath": lambda s, c: trender.render(s, c._replace(integrator="volpath")),
    "progressive": lambda s, c: ProgressiveRenderer(s, ProgressiveConfig(
        render=c, samples_per_progression=1, grid_res=2, n_lobes=2)).run_progression(),
    "render_sharded": lambda s, c: tmesh.render_sharded(
        s, c, mesh=tmesh.make_device_mesh(device="cpu")),
    "ptracer": lambda s, c: tptracer.render_ptracer(s, c, n_particles=256),
    "sppm": lambda s, c: tsppm.render_sppm(s, c, n_iterations=1, photons_per_iter=256),
    "vpl": lambda s, c: tvpl.render_vpl(s, c, n_vpl_paths=8),
    "pssmlt": lambda s, c: tpssmlt.render_pssmlt(s, c, n_chains=32, mutations_per_pixel=1),
    "erpt": lambda s, c: terpt.render_erpt(s, c, chain_length=2),
    "irrcache": lambda s, c: tirrcache.render_irrcache(s, c, n_records=16, rays_per_record=4),
    "subsurface": lambda s, c: tsubsurface.render_subsurface(s, c, n_points=64),
}


def _sss_cornell(mod):
    """Cornell with a dipole row on the tall box and a single-scattering
    row on the short box (tests/test_torch_subsurface.py's scene)."""
    sc = mod.cornell_box()
    sc["shapes"][5]["subsurface"] = {"sigma_a": [0.02, 0.04, 0.1], "sigma_s": [1.2, 1.0, 0.8],
                                     "eta": 1.3}
    sc["shapes"][6]["subsurface"] = {"type": "singlescatter", "sigma_a": 0.05, "sigma_s": 0.8,
                                     "eta": 1.33, "g": 0.5}
    return sc


@pytest.fixture(scope="module")
def route_scenes(cornell):
    return {"cornell": cornell[1], "sss": build_scene(_sss_cornell(tscenes), device="cpu")}


@pytest.mark.parametrize("use_bvh", [None, True, False])
@pytest.mark.parametrize("reader", sorted(READERS))
def test_render_entry_points_read_use_bvh(route_scenes, monkeypatch, reader, use_bvh):
    """Cornell (36 triangles) at 8x8: with ``use_bvh`` True every query
    of the render goes through the BVH, with None (the scene is below
    BRUTE_FORCE_MAX_TRIS) or False none does and the tiled route runs, as
    before the field existed."""
    calls = {"bvh": 0, "tiled": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for attr, name in (("intersect_bvh", "bvh"), ("occluded_bvh", "bvh"),
                       ("intersect_pallas", "tiled"), ("occluded_pallas", "tiled")):
        monkeypatch.setattr(tpath, attr, counting(name, getattr(tpath, attr)))
    scene = route_scenes["sss" if reader == "subsurface" else "cornell"]
    cfg = trender.RenderConfig(width=8, height=8, spp=1, max_depth=3, rr_depth=3,
                               use_bvh=use_bvh)
    img = READERS[reader](scene, cfg)
    if img is not None:
        img = img[0] if isinstance(img, tuple) else img
        assert torch.isfinite(img).all()
    if use_bvh:
        assert calls["bvh"] > 0 and calls["tiled"] == 0, calls
    else:
        assert calls["bvh"] == 0 and calls["tiled"] > 0, calls


@pytest.mark.parametrize("use_bvh", [False, True])
@pytest.mark.parametrize("fn", ["trace_bdpt", "volume_photon_pass"])
def test_tracers_take_use_bvh(route_scenes, monkeypatch, fn, use_bvh):
    """The tracers that no render reads the field for take ``use_bvh``
    as their JAX counterparts do."""
    from mitsuba_path_guiding_torch.core import rng as trng
    from mitsuba_path_guiding_torch.integrators import bdpt as tbdpt
    from mitsuba_path_guiding_torch.integrators import volphoton as tvolphoton

    calls = {"bvh": 0}

    def counting(fn_):
        def wrapped(*a, **k):
            calls["bvh"] += 1
            return fn_(*a, **k)
        return wrapped

    monkeypatch.setattr(tpath, "intersect_bvh", counting(tpath.intersect_bvh))
    scene = route_scenes["cornell"]
    pix = torch.arange(64, dtype=torch.int64)
    keys = trng.ray_keys(trng.base_key(0), pix, torch.zeros_like(pix))
    if fn == "trace_bdpt":
        out = tbdpt.trace_bdpt(scene, keys, pix, 8, 8, max_depth=3, use_bvh=use_bvh)[0]
    else:
        out = tvolphoton.volume_photon_pass(scene, keys, max_depth=3, use_bvh=use_bvh)[0]
    assert torch.isfinite(out).all()
    assert (calls["bvh"] > 0) == use_bvh
