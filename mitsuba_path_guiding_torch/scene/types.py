"""Flat-tensor scene representation (port of the reference's
scene/types.py).

The packed layouts are the reference's, column for column, so that the
same compiled scene can be handed between the two packages
(``convert.scene_from_numpy``):

  * ``Geometry.shade_packed`` (T, 32): 0:3 unit geometric normal, 3:6 n0,
    6:9 n1, 9:12 n2, 12:14 uv0, 14:16 uv1, 16:18 uv2, 18 mat_id,
    19 emitter_id (-1 none), 20:23 emitted radiance, 23 emitter pmf,
    25 triangle area, 26 UV density, 27 sss row, rest zero;
  * ``Materials.packed`` (M, 32): 0 type, 1:4 reflectance, 4:7 specular,
    7:10 eta, 10:13 k, 13 alpha, 14 texture_id, 15 alpha_v, 16 sub_a,
    17 sub_b, 18 weight, 19 bump_tex_id, 20 bump_scale, 21:24 the
    wireframe's edge colour, 24 its line width, 25:27 UV tiling, 27:32
    the cloth's geometry (``BSDFType.CLOTH``);
  * ``Emitters.packed`` (E, 32): 0 kind, 1 pmf, 2:5 radiance,
    5:8 position, 8:11 axis, 11:13 cutoffs, 13 area, 14:17 p0, 17:20 e1,
    20:23 e2, 23:26 unit normal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class BSDFType:
    DIFFUSE = 0
    CONDUCTOR = 1
    DIELECTRIC = 2
    ROUGH_CONDUCTOR = 3
    PLASTIC = 4
    ROUGH_DIELECTRIC = 5
    NULL = 6
    ROUGH_PLASTIC = 7
    ROUGH_DIFFUSE = 8
    PHONG = 9
    MASK = 10
    TWO_SIDED = 11
    WARD = 12
    DIFFTRANS = 13
    BLEND = 14
    COATING = 15
    HK = 16
    THINDIELECTRIC = 17
    CLOTH = 18           # woven cloth (irawan): the weave tile is baked into a
    #                      kd texture (texture_id) and a yarn-record texture
    #                      (bump_tex_id, fetched nearest, never a normal map);
    #                      the row's columns are repurposed: eta = (von Mises
    #                      alpha, beta, ss), k = (psi, umax, kappa), 13 = the
    #                      Ward fallback's alpha, 15 = the specular norm,
    #                      18 = hWidth, 27:32 = (w, l, areaW, areaF, fb_scale)
    N_TYPES = 19


class EmitterKind:
    AREA = 0
    POINT = 1
    CONSTANT = 2
    DIRECTIONAL = 3
    SPOT = 4
    ENVMAP = 5
    COLLIMATED = 6


class SensorKind:
    PERSPECTIVE = 0
    ORTHOGRAPHIC = 1
    SPHERICAL = 2
    TELECENTRIC = 3
    IRRADIANCEMETER = 4
    RADIANCEMETER = 5
    FLUENCEMETER = 6


class Geometry(NamedTuple):
    """Triangle soup, (T,) leading axis, Moeller-Trumbore edges."""

    p0: torch.Tensor      # (T, 3)
    e1: torch.Tensor      # (T, 3) = p1 - p0
    e2: torch.Tensor      # (T, 3) = p2 - p0
    n0: torch.Tensor      # (T, 3) shading normals at vertices
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor     # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # (T,) int32
    emitter_id: torch.Tensor  # (T,) int32, -1 if none
    shade_packed: torch.Tensor  # (T, 32) float32, layout above
    vcol: Optional[torch.Tensor] = None  # (T, 9) vertex colours or None


class Materials(NamedTuple):
    """BSDF parameter table, (M,) leading axis."""

    type: torch.Tensor        # (M,) int32 BSDFType
    reflectance: torch.Tensor  # (M, 3)
    specular: torch.Tensor    # (M, 3)
    eta: torch.Tensor         # (M, 3)
    k: torch.Tensor           # (M, 3)
    alpha: torch.Tensor       # (M,)
    texture_id: torch.Tensor  # (M,) int32, -1 = none
    packed: torch.Tensor      # (M, 32) float32, layout above
    coat_trans: Optional[torch.Tensor] = None  # (M, 16) coat transmittance over cos


class Emitters(NamedTuple):
    """Emitter sampling table (E,) with a power-proportional PMF."""

    kind: torch.Tensor        # (E,) int32 EmitterKind
    tri: torch.Tensor         # (E,) int32 triangle index or -1
    radiance: torch.Tensor    # (E, 3)
    position: torch.Tensor    # (E, 3)
    aux: torch.Tensor         # (E, 3)
    cutoff: torch.Tensor      # (E, 2)
    area: torch.Tensor        # (E,)
    pmf: torch.Tensor         # (E,)
    cdf: torch.Tensor         # (E,)
    env_radiance: torch.Tensor  # (3,) constant-env radiance (zeros if none)
    env_pdf: torch.Tensor       # () uniform-sphere NEE pdf
    env_image: torch.Tensor     # (He, We, 3)
    env_cdf_rows: torch.Tensor  # (He,)
    env_cdf_cols: torch.Tensor  # (He, We)
    env_pdf_tex: torch.Tensor   # (He, We)
    packed: torch.Tensor        # (E, 32) float32, layout above


class Sensor(NamedTuple):
    """Perspective (pinhole, thin lens, radially distorted), orthographic,
    spherical and telecentric cameras and the irradiance, radiance and
    fluence meters; ``kind`` picks the ray-generation branch host-side."""

    to_world: torch.Tensor        # (4, 4) camera-to-world
    tan_half_fov_x: torch.Tensor  # () orthographic/telecentric: half-width
    tan_half_fov_y: torch.Tensor  # ()
    aperture_radius: torch.Tensor  # () 0 = pinhole
    focus_distance: torch.Tensor  # ()
    near_clip: torch.Tensor       # ()
    kind: int                     # SensorKind, host-side
    kc: Optional[torch.Tensor] = None  # (2,) radial distortion: 1 + kc0 r^2 + kc1 r^4
    meas_scale: Optional[torch.Tensor] = None  # () probe weight applied at develop


class MediumData(NamedTuple):
    """Participating-medium parameters (one global medium).  Homogeneous
    media take the closed forms of ``integrators/volpath.py``, grid media
    the tracking loops of ``models/medium.py``; sigma_t(x) = density(x) *
    (sigma_a + sigma_s), the density the constant (1, 1, 1) grid for a
    homogeneous medium.  ``enabled``, ``heterogeneous`` and ``phase_kind``
    are host values: a wave branches on them without reading the card."""

    sigma_a: torch.Tensor        # (3,), any "scale" folded in
    sigma_s: torch.Tensor        # (3,)
    phase_g: torch.Tensor        # () HG anisotropy; 0 isotropic
    enabled: bool
    density: torch.Tensor        # (D, H, W) float32
    world_to_grid: torch.Tensor  # (4, 4) world point -> [0, 1]^3
    majorant: torch.Tensor       # () max density * max channel of sigma_t
    heterogeneous: bool
    phase_kind: int = 0          # models/phase.py PhaseKind
    # fiber phases (kkay, microflake); None for the other families
    orientation: Optional[torch.Tensor] = None  # (3,) fiber axis
    phase_aux: Optional[torch.Tensor] = None    # (4,) kkay: ks, kd, exponent, norm;
    #                                             microflake: stddev, norm, erf c1, mean sigma
    sigt_table: Optional[torch.Tensor] = None   # (64,) microflake sigma_t(cos)
    # mixture phase; None otherwise
    mix_weights: Optional[torch.Tensor] = None  # (K,) normalised weights
    mix_g: Optional[torch.Tensor] = None        # (K,) HG g of each component
    mix_kinds: Optional[torch.Tensor] = None    # (K,) int32 MIX_HG / MIX_RAYLEIGH


class BVH(NamedTuple):
    """Flattened binary BVH (host-built, accel/bvh.py).  Internal node i:
    child0[i], child1[i] >= 0; leaf: child0[i] = -(prim_start + 1),
    child1[i] = -prim_count; ``prim_idx`` permutes into the Geometry
    arrays.  Every compiled scene carries one; ``accel/traverse.py``
    ``intersect_bvh`` walks it, and the block and pair tables are cut
    from it.  A compiled scene's BVH also carries the packed layout the
    CUDA walk reads (``accel/bvh.py`` ``pack_bvh``, the layout in
    ``csrc/device_math.cuh``); the reference has no such fields
    (``PORT_ONLY``)."""

    node_min: torch.Tensor  # (Nn, 3)
    node_max: torch.Tensor  # (Nn, 3)
    child0: torch.Tensor    # (Nn,) int32
    child1: torch.Tensor    # (Nn,) int32
    prim_idx: torch.Tensor  # (T,) int32
    max_depth: int          # host int
    packed_nodes: Optional[torch.Tensor] = None  # (inner nodes + 1, 16) f32
    packed_tris: Optional[torch.Tensor] = None   # (T, 12) f32, leaf order

    PORT_ONLY = ("packed_nodes", "packed_tris")


class BlockList(NamedTuple):
    """Tables of the blocklist intersector (ops/intersect_blocklist.py):
    the BVH cut into treelet blocks of <= 128 triangles, 32 consecutive
    blocks to a superblock."""

    tri_pack: torch.Tensor  # (S, 32, 16, 128) f32: rows p0 e1 e2, row 9
    #                         the original triangle id (-1 padding)
    blk_box: torch.Tensor   # (S, 32, 8) f32: 0:3 lo, 3:6 hi (inverted
    #                         box for padding blocks), 6:8 zero
    sb_lo: torch.Tensor     # (S, 3) superblock AABB
    sb_hi: torch.Tensor     # (S, 3)
    n_blocks: int           # real block count (host int)


class PairTable(NamedTuple):
    """Tables of the pair intersector (ops/intersect_pairs.py)."""

    tri_rows: torch.Tensor  # (B, 10, 128) f32: rows p0 e1 e2, row 9 the
    #                         original triangle id (-1 padding)
    blk_lo: torch.Tensor    # (B, 3) block AABB (never-hit for padding)
    blk_hi: torch.Tensor    # (B, 3)
    sb_lo: torch.Tensor     # (S, 3) superblock AABB (32 consecutive blocks)
    sb_hi: torch.Tensor     # (S, 3)
    tblT: torch.Tensor      # (32*6, S) f32 holding bf16 values: the block
    #                         boxes per superblock, lo rounded down and hi
    #                         up to bf16 (outward-conservative)
    nonempty: torch.Tensor  # (B_ne,) int32 ids of blocks holding triangles
    tri_cols: torch.Tensor  # (B, 16, 5*128) f32 Pluecker columns: per
    #                         triangle 3 edge sides, plane num and den
    #                         against the features [d, o x d, o, 1, 0..]
    prim_loc: torch.Tensor  # (T,) int32 original id -> blk*128 + slot
    tri_flat: torch.Tensor  # (B*128, 10) f32 row-major copy of tri_rows

    @property
    def leaf(self) -> int:
        return int(self.tri_rows.shape[2])

    @property
    def sb_blk(self) -> int:
        return int(self.blk_lo.shape[0]) // int(self.sb_lo.shape[0])


class SceneData(NamedTuple):
    geo: Geometry
    bvh: Optional[BVH]
    mats: Materials
    emitters: Emitters
    sensor: Sensor
    medium: Optional[MediumData]
    aabb_min: torch.Tensor  # (3,)
    aabb_max: torch.Tensor
    textures: torch.Tensor       # (NT, 2*TH, TW, 3) atlas with mip levels (models/texture.py)
    texture_sizes: torch.Tensor  # (NT, 2) each texture's (H, W)
    sss_packed: Optional[torch.Tensor] = None
    blocks: Optional[BlockList] = None  # None below 16384 triangles
    pairs: Optional[PairTable] = None


def pad_to(arr: np.ndarray, n: int, fill=0):
    """Pad a host array's leading axis to n with ``fill``."""
    if arr.shape[0] == n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
