"""Woven cloth (the Irawan-Marschner model): weave parsing, the baked
weave tile and its yarn records (a numpy copy of the reference's
models/cloth.py).

- ``parse_weave`` reads the weave-pattern text format (a tolerant regex
  parser): the yarns, the tile's pattern, ``$identifier`` placeholders
  resolved from the plugin's parameters.
- ``compile_cloth`` bakes one weave tile into a flat per-yarn kd texture
  and a yarn-record texture (the warp/weft bit, the spine parameter u,
  the cross parameter v and the yarn's ks scale), which shading fetches
  with one nearest lookup instead of walking the weave cell.
- The specular normalization is a Monte Carlo estimate at build time
  through ``models.bsdf.cloth_spec_raw`` on numpy (the same integrand the
  renderer evaluates per lane in torch), from ``default_rng(0)``, so the
  compiled rows are equal to the reference's bit for bit.

The per-material geometry scalars (umax, kappa, psi, w, l averaged over
the pattern's yarns) ride repurposed packed columns: see
``scene/types.py`` CLOTH.  The reference's open departures from the
published model are kept as they are: ``parse_weave`` drops the header's
warpArea/weftArea (both read 0.5), the per-yarn ks collapses to a
luminance scale clipped at twice the pattern mean, and the period- and
fineness-driven yarn noise is not modelled.
"""
from __future__ import annotations

import re

import numpy as np


def parse_weave(text: str, params: dict | None = None) -> dict:
    """Parse the reference weave-pattern format (irawan.h grammars):
    ``weave { key = value, ..., pattern { i, j, ... }, yarn { ... } ... }``.
    Angles (umax, psi) are given in degrees, stored in radians — matching
    the reference parser's deg2rad at YarnGrammar.

    ``params`` resolves ``$identifier`` placeholders (irawan.h:309-319:
    the grammar pulls them from the plugin's Properties so one pattern
    file can be recolored per scene); values may be floats or RGB
    triples.  An unresolved placeholder raises, like the reference's
    Properties lookup."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)

    def _sub_param(m):
        name = m.group(1)
        if not params or name not in params:
            raise ValueError(f"weave pattern references undefined ${name}")
        val = params[name]
        if isinstance(val, (list, tuple, np.ndarray)):
            return "{" + ", ".join(str(float(x)) for x in np.ravel(val)) + "}"
        return str(float(val))

    text = re.sub(r"\$([A-Za-z_][A-Za-z0-9_]*)", _sub_param, text)

    def grab_kv(block):
        out = {}
        for m in re.finditer(r"(\w+)\s*=\s*(\{[^}]*\}|[^,}{]+)", block):
            k, v = m.group(1), m.group(2).strip()
            if v.startswith("{"):
                out[k] = [float(x) for x in re.findall(r"[-\d.eE+]+", v)]
            else:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v.strip().strip('"')
        return out

    yarns = []
    # yarn blocks contain one nesting level (kd/ks value lists): match
    # balanced to one level, so that the fields after a list are kept
    for m in re.finditer(r"yarn\s*\{((?:[^{}]|\{[^{}]*\})*)\}", text, re.S):
        y = grab_kv(m.group(1) + "}")
        yarns.append({
            "type": 0 if str(y.get("type", "warp")).lower() == "warp" else 1,
            "psi": np.deg2rad(float(y.get("psi", 0.0))),
            "umax": np.deg2rad(float(y.get("umax", 0.0))),
            "kappa": float(y.get("kappa", 0.0)),
            "width": float(y.get("width", 1.0)),
            "length": float(y.get("length", 1.0)),
            "centerU": float(y.get("centerU", 0.5)),
            "centerV": float(y.get("centerV", 0.5)),
            "kd": np.asarray(y.get("kd", [0.5, 0.5, 0.5]), np.float32),
            "ks": np.asarray(y.get("ks", [0.1, 0.1, 0.1]), np.float32),
        })

    pat = re.search(r"pattern\s*\{([^}]*)\}", text, re.S)
    pattern = [int(float(x)) for x in re.findall(r"[\d]+", pat.group(1))] if pat else []
    head = text[: text.find("yarn")] if "yarn" in text else text
    kv = grab_kv(head)
    tw = int(kv.get("tileWidth", 0) or 0)
    th = int(kv.get("tileHeight", 0) or 0)
    if tw * th == 0 and pattern:
        tw = th = int(np.sqrt(len(pattern)))
    return {
        "name": kv.get("name", "weave"),
        "alpha": float(kv.get("alpha", 0.01)),
        "beta": float(kv.get("beta", 4.0)),
        "ss": float(kv.get("ss", 0.5)),
        "hWidth": float(kv.get("hWidth", 0.5)),
        "tileWidth": tw,
        "tileHeight": th,
        "pattern": pattern,
        "yarns": yarns,
    }


# yarn-record encoding shared by the bake below and the integrator's
# decode (integrators/path.py cloth branch): channel 0 packs the warp/weft
# bit in the upper half-range with u scaled by pi/2; channel 1 is v scaled
# by pi; channel 2 the per-yarn ks luminance scale / 2.  Everything rides
# one float32 RGB atlas slot with a NEAREST fetch (texture.py
# sample_atlas_nearest) — bilinear would blend records across yarn seams.
U_ENC = np.pi / 2.0
V_ENC = np.pi
C0_SPAN = 0.499


def segment_lookup(wp: dict, uu: np.ndarray, vv: np.ndarray):
    """uv (tile-relative, [0,1) after wrap) -> (weft?, u, v, yid) per
    point — the weave-cell walk of irawan.cpp eval :192-270: the pattern
    entry picks the yarn, u/v are spine/cross parameters relative to the
    yarn segment's TILE-level center, weft frames quarter-turned."""
    tw, th = wp["tileWidth"], wp["tileHeight"]
    yarns = wp["yarns"]
    x = uu * tw
    y = (1.0 - vv) * th
    pat = np.asarray(wp["pattern"], np.int64).reshape(th, tw)
    lx = np.clip(x.astype(np.int64), 0, tw - 1)
    ly = np.clip(y.astype(np.int64), 0, th - 1)
    yid = np.clip(pat[ly, lx] - 1, 0, len(yarns) - 1)
    cu = np.array([yn["centerU"] for yn in yarns])
    cv = np.array([yn["centerV"] for yn in yarns])
    sx = x - cu[yid] * tw
    sy = -(y - (1.0 - cv[yid]) * th)
    weft = np.array([yn["type"] for yn in yarns])[yid] == 1
    xx = np.where(weft, -sy, sx)
    yy = np.where(weft, sx, sy)
    w_ = np.array([yn["width"] for yn in yarns])[yid]
    l_ = np.array([yn["length"] for yn in yarns])[yid]
    um = np.array([yn["umax"] for yn in yarns])[yid]
    u = yy / (l_ / 2.0) * um
    v = xx * np.pi / w_
    return weft, u, v, yid


def compile_cloth(wp: dict, res: int = 32):
    """Bake one weave tile.  Returns a dict:
      kd_img   (H,W,3) flat per-yarn diffuse texture
      aux_img  (H,W,3) encoded yarn records (see header constants)
      mean_ks  (3,)
      scalars: alpha, beta, ss, psi, umax, kappa, w, l, h_width,
               area_warp, area_weft  (yarn-averaged geometry)
      norm     MC specular normalization (irawan.cpp configure :139-169),
               computed through models/bsdf.cloth_spec_raw (NumPy backend)
               over the BAKED records so eval and norm share one code path
      a_fb, fb_scale: isotropic-Ward fallback lobe (integrators that do
               not fetch textures), energy-matched by its own MC
    """
    tw, th = wp["tileWidth"], wp["tileHeight"]
    yarns = wp["yarns"]
    if tw * th == 0 or not yarns:
        raise ValueError("weave pattern has no tile/yarns")
    H, W = th * res, tw * res
    xi = (np.arange(W) + 0.5) / W
    yi = (np.arange(H) + 0.5) / H
    UU, YY = np.meshgrid(xi, yi, indexing="xy")  # YY = image row fraction
    # image row r holds uv with (1 - v)*H in [r, r+1) (sample_atlas flip)
    weft, u, v, yid = segment_lookup(wp, UU.ravel(), 1.0 - YY.ravel())
    kd_tab = np.stack([yn["kd"] for yn in yarns]).astype(np.float32)
    ks_tab = np.stack([yn["ks"] for yn in yarns]).astype(np.float32)
    mean_ks = ks_tab.mean(0)
    ks_lum = ks_tab.mean(-1)
    ks_scale = ks_lum / max(float(mean_ks.mean()), 1e-9)
    kd_img = kd_tab[yid].reshape(H, W, 3)
    c0 = weft * 0.5 + np.clip((u / U_ENC + 1.0) * 0.5, 0.0, 1.0) * C0_SPAN
    c1 = np.clip((v / V_ENC + 1.0) * 0.5, 0.0, 1.0)
    c2 = np.clip(ks_scale[yid] * 0.5, 0.0, 1.0)
    aux_img = np.stack([c0, c1, c2], -1).reshape(H, W, 3).astype(np.float32)

    sc = dict(
        alpha=float(wp["alpha"]), beta=float(wp["beta"]),
        ss=float(wp["ss"]), h_width=float(wp["hWidth"]),
        psi=float(np.mean([yn["psi"] for yn in yarns])),
        umax=float(np.mean([yn["umax"] for yn in yarns])),
        kappa=float(np.mean([yn["kappa"] for yn in yarns])),
        w=float(np.mean([yn["width"] for yn in yarns])),
        l=float(np.mean([yn["length"] for yn in yarns])),
    )
    wa = float(wp.get("warpArea", 0.5)) or 0.5
    we = float(wp.get("weftArea", 0.5)) or 0.5
    sc["area_warp"] = (wa + we) / wa
    sc["area_weft"] = (wa + we) / we

    # reference validity guards (irawan.cpp:396-406) — enforced here so
    # the per-lane integrand needs no checks; invalid geometry keeps the
    # diffuse term and drops the specular, like the reference's 0 return
    valid = (
        0.0 <= sc["ss"] < 1.0
        and sc["w"] * np.sin(sc["umax"]) < sc["l"]
        and sc["kappa"] >= -1.0
    )

    # MC normalization through the real integrand over the baked records
    from mitsuba_path_guiding_torch.models.bsdf import cloth_spec_raw

    rng = np.random.default_rng(0)
    n = 40000

    def cos_hemi(un):
        r = np.sqrt(un[:, 0])
        phi = 2.0 * np.pi * un[:, 1]
        z = np.sqrt(np.maximum(1.0 - un[:, 0], 0.0))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)

    norm = 0.0
    if valid:
        wi = cos_hemi(rng.random((n, 2)))
        wo = cos_hemi(rng.random((n, 2)))
        uvm = rng.random((n, 2))
        # round-trip through the ENCODED image exactly like the renderer
        px = np.clip((uvm[:, 0] * W).astype(np.int64), 0, W - 1)
        py = np.clip(((1.0 - uvm[:, 1]) * H).astype(np.int64), 0, H - 1)
        rec = aux_img[py, px]
        b_d, u_d, v_d, _ = decode_record(rec)
        raw = np.asarray(cloth_spec_raw(
            wi, wo, b_d, u_d, v_d, sc["alpha"], sc["beta"], sc["ss"],
            sc["psi"], sc["umax"], sc["kappa"], sc["w"], sc["l"],
            sc["h_width"], sc["area_warp"], sc["area_weft"], xp=np))
        m = float(raw.mean())
        norm = 1.0 / (m * np.pi) if m > 1e-12 else 0.0
        # cosine-weighted specular output of the exact model — the
        # radiometric target the Ward fallback must reproduce
        m_exact_co = float((raw * norm * wo[:, 2]).mean())

    # fallback isotropic Ward (integrators that fetch no texture): the
    # band half-width as alpha, with its own MC energy match
    a_fb = float(np.clip(sc["umax"] * sc["h_width"], 0.08, 0.6))
    fb_scale = 0.0
    if valid:
        wi = cos_hemi(rng.random((n, 2)))
        wo = cos_hemi(rng.random((n, 2)))
        hraw = wi + wo
        hn = hraw / np.maximum(
            np.linalg.norm(hraw, axis=-1, keepdims=True), 1e-12)
        tan2 = (hn[:, 0] ** 2 + hn[:, 1] ** 2) / np.maximum(
            hn[:, 2] ** 2, 1e-8)
        ward = np.exp(-tan2 / (a_fb * a_fb)) / (
            4.0 * np.pi * a_fb * a_fb
            * np.sqrt(np.maximum(wi[:, 2] * wo[:, 2], 1e-8)))
        # match the exact model's COSINE-WEIGHTED specular energy (plain
        # 1/(pi*mean) over-brightens ~9%: the narrow lobe concentrates
        # where cos is large while the band spec spreads wide)
        mw = float((ward * wo[:, 2]).mean())
        fb_scale = m_exact_co / mw if mw > 1e-12 else 0.0

    return dict(
        kd_img=kd_img, aux_img=aux_img, mean_ks=mean_ks, norm=float(norm),
        a_fb=a_fb, fb_scale=float(fb_scale), **sc,
    )


def decode_record(rec):
    """Inverse of the aux encoding; works on numpy arrays and tensors.
    Returns (weft bool, u, v, ks_scale)."""
    c0, c1, c2 = rec[..., 0], rec[..., 1], rec[..., 2]
    weft = c0 >= 0.5
    u = ((c0 - weft * 0.5) / C0_SPAN * 2.0 - 1.0) * U_ENC
    v = (c1 * 2.0 - 1.0) * V_ENC
    return weft, u, v, c2 * 2.0


# a built-in plain weave (the simplest 2x2 over/under pattern) used when
# no filename is given — handy default + test fixture
PLAIN_WEAVE = """
weave {
    name = "plain",
    betaM = 4.0, alpha = 0.01, beta = 4.0, ss = 0.5, hWidth = 0.5,
    warpArea = 0.5, weftArea = 0.5,
    tileWidth = 2, tileHeight = 2,
    pattern { 1, 2, 2, 1 },
    yarn { type = warp, umax = 35, kappa = 0.5, width = 1, length = 1,
           centerU = 0.5, centerV = 0.5,
           kd = {0.45, 0.4, 0.36}, ks = {0.2, 0.19, 0.18} },
    yarn { type = weft, umax = 35, kappa = 0.5, width = 1, length = 1,
           centerU = 0.5, centerV = 0.5,
           kd = {0.4, 0.36, 0.45}, ks = {0.18, 0.18, 0.2} }
}
"""
