"""The Cornell box as the benchmark runs it, frozen: 36 triangles, five
diffuse walls (open towards the camera), two white boxes and one area
light under the ceiling (graphics.cornell.edu/online/box/data.html, in
this repository's metres-ish units)."""
from pgbench.scenes._transforms import look_at, rotate, scale, translate


def describe():
    white = {"type": "diffuse", "reflectance": [0.725, 0.71, 0.68]}
    red = {"type": "diffuse", "reflectance": [0.63, 0.065, 0.05]}
    green = {"type": "diffuse", "reflectance": [0.14, 0.45, 0.091]}
    shapes = [
        {"type": "rectangle", "to_world": translate(0, 0, 0) @ rotate([1, 0, 0], -90) @ scale(1.0),
         "bsdf": white},
        {"type": "rectangle", "to_world": translate(0, 2, 0) @ rotate([1, 0, 0], 90) @ scale(1.0),
         "bsdf": white},
        {"type": "rectangle", "to_world": translate(0, 1, 1) @ rotate([1, 0, 0], 180) @ scale(1.0),
         "bsdf": white},
        {"type": "rectangle", "to_world": translate(-1, 1, 0) @ rotate([0, 1, 0], 90) @ scale(1.0),
         "bsdf": red},
        {"type": "rectangle", "to_world": translate(1, 1, 0) @ rotate([0, 1, 0], -90) @ scale(1.0),
         "bsdf": green},
        {"type": "cube",
         "to_world": translate(-0.35, 0.6, 0.45) @ rotate([0, 1, 0], 20) @ scale(0.3, 0.6, 0.3),
         "bsdf": white},
        {"type": "cube",
         "to_world": translate(0.4, 0.3, -0.1) @ rotate([0, 1, 0], -18) @ scale(0.3, 0.3, 0.3),
         "bsdf": white},
        {"type": "rectangle",
         "to_world": translate(0, 1.995, 0) @ rotate([1, 0, 0], 90) @ scale(0.25),
         "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
         "emitter": {"radiance": [17.0, 12.0, 4.0]}},
    ]
    return {"sensor": {"type": "perspective", "fov": 60.0,
                       "to_world": look_at([0, 1.0, -3.2], [0, 1.0, 0])},
            "shapes": shapes, "emitters": []}
