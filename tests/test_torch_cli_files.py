"""The port's scene-file entry point on the CPU: the CLI on an XML Cornell
box (``-D``, the XML's settings, ``-x``, ``--no-nee``, ``-q``/``-v``),
checkpoints written by either package loaded in the other and resumed,
the logger, render queue and preview server (twins of
tests/test_observability.py), ``render_progressive`` and ``image()``,
the tiled film (twin of tests/test_tiled_film.py) and every ``util``
subcommand against the JAX package's."""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch
from torch_port_parity import port_grid, to_numpy_tree

from mitsuba_path_guiding_torch import render as cli
from mitsuba_path_guiding_torch import util
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
    render_progressive,
)
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml
from mitsuba_path_guiding_torch.utils import logger as mlog
from mitsuba_path_guiding_torch.utils.checkpoint import load_renderer_state, save_renderer_state
from mitsuba_path_guiding_torch.utils.logger import (
    EDebug,
    EInfo,
    ETrace,
    EWarn,
    Logger,
    MemoryAppender,
    RenderEvent,
    RenderListener,
    RenderQueue,
)
from test_torch_scene import _compare

RES = 16
SETTINGS = {"width": RES, "height": RES, "spp": 4, "max_depth": 3, "rr_depth": 2}


@pytest.fixture(scope="module")
def xml_dir(tmp_path_factory):
    """The Cornell box as XML (chip_smoke.scene_xml, <matrix> transforms)
    with SETTINGS in its film, sampler and integrator, and a copy whose
    film width is ``$w`` with a default of 8."""
    from chip_smoke import scene_xml

    d = tmp_path_factory.mktemp("xml")
    path = scene_xml(tscenes.cornell_box(), str(d), "cornell", SETTINGS)
    text = open(path).read()
    text = text.replace(f'<integer name="width" value="{RES}"/>',
                        '<integer name="width" value="$w"/>')
    text = text.replace('<scene version="0.6.0">',
                        '<scene version="0.6.0"><default name="w" value="8"/>')
    with open(d / "cornell_w.xml", "w") as f:
        f.write(text)
    return d


@pytest.fixture(scope="module")
def cornell():
    return build_scene(tscenes.cornell_box(), device="cpu")


def run_cli(argv):
    assert cli.main(argv + ["--device", "cpu"]) == 0


def progressive_image(scene, spp, use_nee=True, guiding=True):
    rcfg = RenderConfig(width=RES, height=RES, spp=0, max_depth=SETTINGS["max_depth"],
                        rr_depth=SETTINGS["rr_depth"], use_nee=use_nee)
    cfg = ProgressiveConfig(render=rcfg, samples_per_progression=min(4, spp),
                            n_progressions=max(1, spp // 4), guiding=guiding)
    return ProgressiveRenderer(scene, cfg).render().numpy()


@pytest.fixture(autouse=True)
def _restore_log_level():
    level = mlog.get_logger().level
    yield
    mlog.set_log_level(level)


# --- the CLI on an XML scene -------------------------------------------------

def test_cli_xml_settings_and_defines(xml_dir, cornell, tmp_path):
    """The XML's film, sampler and integrator set the render (the image
    equals a ProgressiveRenderer's at SETTINGS); -D fills $w, and without
    it the <default> does."""
    out = str(tmp_path / "a.npy")
    run_cli([str(xml_dir / "cornell.xml"), "-o", out])
    assert np.array_equal(np.load(out), progressive_image(cornell, SETTINGS["spp"]))
    run_cli([str(xml_dir / "cornell_w.xml"), "-D", f"w={RES}", "-o", out, "-s", "1"])
    assert np.load(out).shape == (RES, RES, 3)
    run_cli([str(xml_dir / "cornell_w.xml"), "-o", out, "-s", "1"])
    assert np.load(out).shape == (RES, 8, 3)


def test_cli_skip_existing(xml_dir, tmp_path):
    out = tmp_path / "x.npy"
    np.save(out, np.zeros((2, 2, 3), np.float32))
    before = out.read_bytes()
    run_cli([str(xml_dir / "cornell.xml"), "-o", str(out), "-x"])
    assert out.read_bytes() == before


@pytest.mark.parametrize("integrator", ["path", "guided"])
def test_cli_no_nee(xml_dir, cornell, tmp_path, integrator):
    """--no-nee reaches RenderConfig.use_nee on both CLI paths."""
    out = str(tmp_path / "n.npy")
    run_cli([str(xml_dir / "cornell.xml"), "-o", out, "-I", integrator, "--no-nee"])
    if integrator == "path":
        want = render(cornell, RenderConfig(width=RES, height=RES, spp=SETTINGS["spp"],
                                            max_depth=SETTINGS["max_depth"],
                                            rr_depth=SETTINGS["rr_depth"], use_nee=False))
        want = want.numpy()
    else:
        want = progressive_image(cornell, SETTINGS["spp"], use_nee=False)
    got = np.load(out)
    assert np.array_equal(got, want)
    run_cli([str(xml_dir / "cornell.xml"), "-o", out, "-I", integrator])
    assert not np.array_equal(np.load(out), got)


@pytest.mark.parametrize("flags,level", [(["-q"], EWarn), ([], EInfo), (["-v"], EDebug),
                                         (["-vv"], ETrace)])
def test_cli_log_levels(xml_dir, tmp_path, capsys, flags, level):
    run_cli([str(xml_dir / "cornell.xml"), "-o", str(tmp_path / "q.npy"), "-s", "1"] + flags)
    assert mlog.get_logger().level == level
    err = capsys.readouterr().err
    if flags == ["-q"]:
        assert err == ""
    else:
        assert "progression 1/1: 1 spp" in err and "render time" in err


# --- checkpoints ---------------------------------------------------------------

def _pcfg(mod_cfg, mod_render):
    return mod_cfg(render=mod_render(width=8, height=8, spp=0, max_depth=2),
                   samples_per_progression=2, n_progressions=2, guiding=True, grid_res=4,
                   n_lobes=2)


@pytest.fixture(scope="module")
def jax_renderer():
    """The JAX package's renderer after one progression on Cornell at 8x8."""
    from mitsuba_path_guiding_tpu.integrators import progressive as jprog
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRC
    from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build
    from mitsuba_path_guiding_tpu.scene.scenes import cornell_box as j_cornell

    r = jprog.ProgressiveRenderer(j_build(j_cornell()), _pcfg(jprog.ProgressiveConfig, JRC))
    r.run_progression()
    return r


def _same_state(port, ref):
    assert np.array_equal(port.film.rgb_weight.numpy(), np.asarray(ref.film.rgb_weight))
    assert (port.film.width, port.film.height) == (ref.film.width, ref.film.height)
    assert (port.sample_counter, port.progression) == (ref.sample_counter, ref.progression)
    _compare(port.grid, ref.grid, "grid")


def test_checkpoint_from_jax_loads_in_the_port(jax_renderer, cornell, tmp_path):
    from mitsuba_path_guiding_tpu.utils.checkpoint import save_renderer_state as j_save

    path = str(tmp_path / "j.npz")
    j_save(jax_renderer, path)
    port = ProgressiveRenderer(cornell, _pcfg(ProgressiveConfig, RenderConfig))
    load_renderer_state(port, path)
    _same_state(port, jax_renderer)
    assert isinstance(port.grid.res0, int) and isinstance(port.grid.n_used, int)


def test_checkpoint_from_the_port_loads_in_jax(jax_renderer, cornell, tmp_path):
    """A port renderer holding the JAX renderer's state saves a file that
    JAX loads back to that state; the port's own progression saves too."""
    from mitsuba_path_guiding_torch.film.film import Film
    from mitsuba_path_guiding_tpu.integrators import progressive as jprog
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRC
    from mitsuba_path_guiding_tpu.utils.checkpoint import load_renderer_state as j_load

    port = ProgressiveRenderer(cornell, _pcfg(ProgressiveConfig, RenderConfig))
    port.film = Film(torch.as_tensor(np.array(jax_renderer.film.rgb_weight)), 8, 8)
    port.grid = port_grid(jax_renderer.grid)
    port.sample_counter, port.progression = jax_renderer.sample_counter, 1
    path = str(tmp_path / "p.npz")
    save_renderer_state(port, path)
    back = jprog.ProgressiveRenderer(jax_renderer.scene, _pcfg(jprog.ProgressiveConfig, JRC))
    j_load(back, path)
    _same_state(port, back)
    assert to_numpy_tree(back.grid)["res0"].dtype == np.int32

    own = ProgressiveRenderer(cornell, _pcfg(ProgressiveConfig, RenderConfig))
    own.run_progression()
    save_renderer_state(own, path)
    j_load(back, path)
    _same_state(own, back)


def test_checkpoint_resume_equals_one_run(xml_dir, tmp_path):
    """Two CLI runs of -s 4 -c equal one of -s 8, bit for bit."""
    xml, ckpt = str(xml_dir / "cornell.xml"), str(tmp_path / "c.npz")
    half, full = str(tmp_path / "h.npy"), str(tmp_path / "f.npy")
    for _ in range(2):
        run_cli([xml, "-s", "4", "-c", ckpt, "-o", half])
    run_cli([xml, "-s", "8", "-o", full])
    assert np.array_equal(np.load(half), np.load(full))
    assert int(np.load(ckpt)["sample_counter"]) == 8


# --- twins of tests/test_observability.py --------------------------------------

def test_logger_levels_and_appenders():
    lg = Logger(EInfo)
    mem = MemoryAppender()
    lg.add_appender(mem)
    lg.debug("below threshold %d", 1)
    lg.info("hello %s", "world")
    lg.warn("careful")
    assert len(mem.records) == 2
    assert "hello world" in mem.records[0][1]
    assert mem.records[1][0] == EWarn
    lg.set_log_level(EDebug)
    lg.debug("now visible")
    assert len(mem.records) == 3
    mem2 = MemoryAppender()
    lg.add_appender(mem2)
    lg.info("fan-out")
    assert len(mem2.records) == 1 and len(mem.records) == 4
    lg.remove_appender(mem2)
    lg.info("one")
    assert len(mem2.records) == 1 and len(mem.records) == 5
    lg.clear_appenders()
    assert lg.appenders == []


def test_logger_error_raises(tmp_path):
    lg = Logger()
    mem = MemoryAppender()
    lg.add_appender(mem)
    path = str(tmp_path / "log.txt")
    lg.add_appender(mlog.FileAppender(path))
    with pytest.raises(RuntimeError, match="boom"):
        lg.error("boom")
    assert len(mem.records) == 1
    assert "ERROR" in open(path).read()


def test_warn_once_dedup():
    lg = Logger()
    mem = MemoryAppender()
    lg.add_appender(mem)
    for _ in range(5):
        lg.warn_once("same %d", 7)
    lg.warn_once("same %d", 8)
    assert len(mem.records) == 2


def test_progress_reaches_appender():
    lg = Logger()
    mem = MemoryAppender()
    lg.add_appender(mem)
    for p in (0.0, 0.5, 1.0):
        lg.log_progress(p, "Rendering")
    assert [p for p, _ in mem.progress] == [0.0, 0.5, 1.0]


def test_render_queue_fanout():
    events = []

    class L(RenderListener):
        def on_begin(self, ev):
            events.append(("begin", ev.n_progressions))

        def on_progression(self, ev):
            events.append(("prog", ev.progression))

        def on_refresh(self, ev):
            events.append(("refresh", ev.image is not None))

        def on_finish(self, ev):
            events.append(("finish", ev.spp_done))

    lg = Logger()
    lg.add_appender(MemoryAppender())
    q = RenderQueue(logger=lg)
    q.register(L())
    q.begin(2)
    q.progression(0, 2, 4, image=np.zeros((4, 4, 3)))
    q.progression(1, 2, 8)
    q.finish(8)
    assert events == [("begin", 2), ("prog", 0), ("refresh", True), ("prog", 1),
                      ("finish", 8)]


def test_preview_server_serves_progressive_image():
    from mitsuba_path_guiding_torch.utils.preview import PreviewServer, encode_png
    from mitsuba_path_guiding_tpu.utils.preview import encode_png as j_encode_png

    srv = PreviewServer(port=0)
    try:
        img = np.zeros((8, 8, 3), np.float32)
        img[:, :, 0] = 0.5
        ev = RenderEvent("progression", progression=0, n_progressions=2, spp_done=4,
                         elapsed_s=1.0, image=img)
        srv.on_progression(ev)
        base = f"http://127.0.0.1:{srv.port}"
        assert b"render preview" in urllib.request.urlopen(base + "/", timeout=5).read()
        st = json.loads(urllib.request.urlopen(base + "/status", timeout=5).read())
        assert st["version"] == 1 and st["spp"] == 4 and not st["finished"]
        png = urllib.request.urlopen(base + "/image.png", timeout=5).read()
        assert png == encode_png(img) == j_encode_png(img)
        srv.on_finish(RenderEvent("finish", spp_done=8, elapsed_s=2.0, image=img))
        st = json.loads(urllib.request.urlopen(base + "/status", timeout=5).read())
        assert st["version"] == 2 and st["finished"]
    finally:
        srv.close()


def test_preview_render_controls(cornell):
    """Stop through the listener's controls ends the progressive loop early
    with the samples so far; exposure re-encodes the served image; the
    listener receives host numpy images."""
    from mitsuba_path_guiding_torch.utils.preview import PreviewServer

    srv = PreviewServer(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        urllib.request.urlopen(base + "/control?exposure=2", timeout=5)
        seen = []
        orig_update, orig_state = srv._update, srv.control_state
        srv._update = lambda ev, finished: (seen.append(type(ev.image)),
                                            orig_update(ev, finished))
        calls = {"n": 0}

        def counting():
            calls["n"] += 1
            st = orig_state()
            st["stop"] = calls["n"] > 2
            return st

        srv.control_state = counting
        cfg = ProgressiveConfig(render=RenderConfig(width=8, height=8, spp=0, max_depth=2),
                                samples_per_progression=1, n_progressions=4,
                                queue=RenderQueue(listeners=[srv]))
        r = ProgressiveRenderer(cornell, cfg)
        img = r.render()
        assert bool(torch.isfinite(img).all()) and r.sample_counter == 2
        assert seen == [np.ndarray] * 3
        bright = urllib.request.urlopen(base + "/image.png", timeout=5).read()
        urllib.request.urlopen(base + "/control?exposure=-6", timeout=5)
        dark = urllib.request.urlopen(base + "/image.png", timeout=5).read()
        assert bright != dark and len(dark) > 8
        assert orig_state()["exposure"] == -6.0
    finally:
        srv.close()


# --- render_progressive, image(), the hooks ------------------------------------

def test_render_progressive_image_and_hooks(cornell):
    """render_progressive is the renderer's render(); image() is the
    developed film on the host; the hooks run around each progression and
    train_progressions stops the fit; with no listener the loop reads no
    image back."""
    cfg = ProgressiveConfig(render=RenderConfig(width=8, height=8, spp=0, max_depth=3),
                            samples_per_progression=2, n_progressions=3, grid_res=4,
                            n_lobes=2)
    img = render_progressive(cornell, cfg)
    pre, post, grids = [], [], []
    cfg2 = cfg.__class__(**{**cfg.__dict__, "train_progressions": 1,
                            "on_preprogression": lambda r: pre.append(r.progression),
                            "on_postprogression": lambda r: (post.append(r.progression),
                                                             grids.append(r.grid))})
    r = ProgressiveRenderer(cornell, cfg2)
    reads = []
    real_image = r.image
    r.image = lambda: reads.append(1) or real_image()
    img2 = r.render()
    assert pre == [0, 1, 2] and post == [1, 2, 3] and reads == []
    assert grids[1] is grids[0] and grids[2] is grids[0]
    assert torch.equal(torch.as_tensor(r.image()), img2)
    r1 = ProgressiveRenderer(cornell, cfg)
    assert torch.equal(r1.render(), img)
    assert r1.image().shape == (8, 8, 3) and isinstance(r1.image(), np.ndarray)


# --- the tiled film ---------------------------------------------------------------

def test_tiled_matches_inmemory(cornell, tmp_path):
    """Twin of tests/test_tiled_film.py: ragged bands of 7 rows read back as
    the in-memory render; the writer's bytes equal the JAX writer's."""
    from mitsuba_path_guiding_torch.film.tiled import TiledEXRWriter, render_tiled
    from mitsuba_path_guiding_tpu.film.tiled import TiledEXRWriter as JWriter

    cfg = RenderConfig(width=24, height=24, spp=4, max_depth=3, seed=1)
    path = str(tmp_path / "tiled.exr")
    render_tiled(cornell, cfg, path, band_rows=7)
    img_t = util._read(path)
    img_m = render(cornell, cfg).numpy()
    assert img_t.shape == (24, 24, 3)
    np.testing.assert_allclose(img_t, img_m, rtol=2e-4, atol=2e-5)
    band = np.random.default_rng(2).random((3, 5, 3)).astype(np.float32)
    for cls, name in ((TiledEXRWriter, "p.exr"), (JWriter, "j.exr")):
        w = cls(str(tmp_path / name), 5, 3)
        w.write_band(band)
        w.close()
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()


# --- util: every subcommand against the JAX package's -------------------------------

@pytest.fixture(scope="module")
def util_files(tmp_path_factory, xml_dir):
    from mitsuba_path_guiding_torch.film.film import write_image
    from mitsuba_path_guiding_torch.scene.shapes import make_sphere, save_serialized
    from test_torch_loaders import DAE

    d = tmp_path_factory.mktemp("util")
    rs = np.random.default_rng(7)
    for name in ("a", "b", "alb", "nrm"):
        write_image(str(d / f"{name}.pfm"), rs.random((12, 10, 3)).astype(np.float32) * 2.0)
    save_serialized(str(d / "m.serialized"), [make_sphere(6, 12)])
    (d / "s.dae").write_text(DAE.format(up="Y_UP"))
    return d


UTIL_RUNS = {
    "tonemap": lambda d, o: ["tonemap", f"{d}/a.pfm", o("npy"), "--key", "0.3"],
    "addimages": lambda d, o: ["addimages", f"{d}/a.pfm", f"{d}/b.pfm", o("pfm"), "-w", "0.3",
                               "0.9"],
    "diff": lambda d, o: ["diff", f"{d}/a.pfm", f"{d}/b.pfm", "-o", o("npy")],
    "info": lambda d, o: ["info", "XML"],
    "denoise": lambda d, o: ["denoise", f"{d}/a.pfm", f"{d}/alb.pfm", f"{d}/nrm.pfm", o("npy")],
    "joinrgb": lambda d, o: ["joinrgb", f"{d}/a.pfm", f"{d}/b.pfm", f"{d}/alb.pfm", o("npy")],
    "scene2obj": lambda d, o: ["scene2obj", "XML", o("obj")],
    "serialized2obj": lambda d, o: ["serialized2obj", f"{d}/m.serialized", o("obj")],
    "import": lambda d, o: ["import", f"{d}/s.dae", o("obj")],
}
TORCH_TOOLS = ("tonemap", "denoise", "info", "scene2obj", "import", "kdbench")


@pytest.mark.parametrize("tool", sorted(UTIL_RUNS))
def test_util_subcommand_matches_jax(tool, util_files, xml_dir, tmp_path, capsys):
    """The port's and the JAX package's mtsutil on the same files: the same
    printed lines (paths aside) and the same output file (torch math
    within rtol 1e-5)."""
    from mitsuba_path_guiding_tpu import util as jutil

    xml = str(xml_dir / "cornell.xml")
    outs = {}

    def run(mod, tag, extra):
        o = lambda ext: outs.setdefault(tag, str(tmp_path / f"{tag}.{ext}"))
        argv = [xml if a == "XML" else a for a in UTIL_RUNS[tool](str(util_files), o)]
        assert mod.main(argv + extra) in (0, None)
        return capsys.readouterr().out.replace(outs.get(tag, "\0"), "OUT")

    printed = run(util, "port", ["--device", "cpu"] if tool in TORCH_TOOLS else [])
    want = run(jutil, "jax", [])
    assert printed == want
    if "port" not in outs:
        return
    got, ref = outs["port"], outs["jax"]
    if got.endswith(".obj"):
        assert open(got).read() == open(ref).read()
    else:
        a, b = util._read(got), util._read(ref)
        assert a.shape == b.shape
        if tool in TORCH_TOOLS:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b)


def test_util_kdbench_runs(xml_dir, capsys):
    """kdbench on the CPU times the plain BVH walk and prints its rate."""
    assert util.main(["kdbench", str(xml_dir / "cornell.xml"), "-x", "2048",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "BVH build: 36 tris" in out and "BVH (plain) traversal: 2048 rays" in out
    assert "Mrays/s" in out
    assert os.path.exists(xml_dir / "cornell.xml")
