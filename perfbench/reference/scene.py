"""The plain reference's own reading of a `.scn` file.

Written from the upstream grammar (lilinitsy/skele-raytracer
src/scene.cpp:12-227), independent of the program under test: one command
per line, the first token names it, fields convert like sscanf %f (a
missing or garbled field reads 0), and a material applies to every shape
that follows it. The two semantics differ here as in the upstream:

* parity: directional lights are never stored (src/scene.cpp:139-163) and
  `spherical_fog` converts no field (its format string starts with
  "fog", src/scene.cpp:210), which this reading stands in for with an
  all-zero fog that turns the point-light block off;
* clean: both as written.

`Scene` holds float tensors of one dtype on one device; `leaves()` names
them as the program's scene does ("spheres.diffuse", ...), so a training
cell can name the leaves it trains in one vocabulary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

MAT_KEYS = ("ambient", "diffuse", "specular", "transmissive", "power", "ior")


def _floats(tokens, n):
    out = []
    for i in range(n):
        try:
            out.append(float(tokens[i]))
        except (IndexError, ValueError):
            out.append(0.0)
    return out


@dataclass
class Parsed:
    """The file as written: lists of records and the scalar commands."""

    width: int = 1920
    height: int = 1080
    spheres: list = field(default_factory=list)
    triangles: list = field(default_factory=list)
    point_lights: list = field(default_factory=list)
    directional_lights: list = field(default_factory=list)
    fog: list = field(default_factory=list)
    ambient: tuple = (0.0, 0.0, 0.0)
    background: tuple = (0.0, 0.0, 0.0)
    camera: tuple = ((0.0, 0.0, 0.0),) * 3  # position, direction, up


def parse(text: str) -> Parsed:
    out = Parsed()
    verts = []
    mat = dict(ambient=(0.0,) * 3, diffuse=(0.0,) * 3, specular=(0.0,) * 3,
               transmissive=(0.0,) * 3, power=1.0, ior=1.0)
    amb = [0.0, 0.0, 0.0]
    for line in text.splitlines():
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        cmd, a = tok[0], tok[1:]
        if cmd == "sphere":
            x, y, z, r = _floats(a, 4)
            out.spheres.append(dict(center=(x, y, z), radius=r, **mat))
        elif cmd == "vertex":
            verts.append(tuple(_floats(a, 3)))
        elif cmd == "triangle":
            idx = [int(v) for v in _floats(a, 3)]  # floats, truncated
            if all(0 <= i < len(verts) for i in idx):
                out.triangles.append(dict(v0=verts[idx[0]], v1=verts[idx[1]],
                                          v2=verts[idx[2]], **mat))
        elif cmd == "camera":
            f = _floats(a, 10)
            out.camera = (tuple(f[0:3]), tuple(f[3:6]), tuple(f[6:9]))
        elif cmd == "film_resolution":
            w, h = _floats(a, 2)
            out.width, out.height = int(w), int(h)
        elif cmd == "background":
            out.background = tuple(_floats(a, 3))
        elif cmd == "material":
            f = _floats(a, 14)
            mat = dict(ambient=tuple(f[0:3]), diffuse=tuple(f[3:6]),
                       specular=tuple(f[6:9]), power=f[9],
                       transmissive=tuple(f[10:13]), ior=f[13])
        elif cmd == "directional_light":
            r, g, b, x, y, z = _floats(a, 6)
            out.directional_lights.append(dict(
                direction=(x, y, z), colour=(min(r, 1.0), min(g, 1.0),
                                             min(b, 1.0))))
        elif cmd == "point_light":
            r, g, b, x, y, z = _floats(a, 6)
            out.point_lights.append(dict(position=(x, y, z),
                                         colour=(r, g, b)))
        elif cmd == "ambient_light":
            for i, v in enumerate(_floats(a, 3)):
                amb[i] += v
            out.ambient = tuple(amb)
        elif cmd == "spherical_fog":
            x, y, z, rad, r, g, b, s, ab = _floats(a, 9)
            out.fog.append(dict(center=(x, y, z), radius=rad,
                                albedo=(r, g, b), scattering=s,
                                absorption=ab))
    return out


@dataclass
class Scene:
    """Tensors of the scene in one dtype on one device. Groups are dicts
    of tensors; a group with no records has none."""

    spheres: dict
    triangles: dict
    point_lights: dict
    directional_lights: dict
    fog: dict
    ambient: torch.Tensor
    background: torch.Tensor
    camera: dict
    fog_zeroed: bool
    width: int
    height: int

    GROUPS = ("spheres", "triangles", "point_lights", "directional_lights",
              "fog", "camera")

    def leaves(self):
        """(dotted name, tensor) of every leaf."""
        out = []
        for g in self.GROUPS:
            out += [(f"{g}.{k}", v) for k, v in getattr(self, g).items()]
        return out + [("ambient", self.ambient),
                      ("background", self.background)]

    def with_leaves(self, new: dict) -> "Scene":
        """A copy with the leaves named in `new` replaced."""
        kw = {}
        for g in self.GROUPS:
            grp = dict(getattr(self, g))
            for k in grp:
                grp[k] = new.get(f"{g}.{k}", grp[k])
            kw[g] = grp
        for k in ("ambient", "background"):
            kw[k] = new.get(k, getattr(self, k))
        return dataclasses.replace(self, **kw)


def _group(records, keys, dtype, device):
    if not records:
        return {}
    return {k: torch.tensor(np.asarray([r[k] for r in records], np.float32),
                            device=device).to(dtype) for k in keys}


def build(parsed: Parsed, parity: bool, dtype=torch.float32,
          device="cpu") -> Scene:
    t = lambda v: torch.tensor(np.asarray(v, np.float32),
                               device=device).to(dtype)
    fog = parsed.fog
    if parity and fog:
        fog = [dict(center=(0.0,) * 3, radius=0.0, albedo=(0.0,) * 3,
                    scattering=0.0, absorption=0.0) for _ in fog]
    pos, direction, up = parsed.camera
    return Scene(
        spheres=_group(parsed.spheres, ("center", "radius") + MAT_KEYS,
                       dtype, device),
        triangles=_group(parsed.triangles, ("v0", "v1", "v2") + MAT_KEYS,
                         dtype, device),
        point_lights=_group(parsed.point_lights, ("position", "colour"),
                            dtype, device),
        directional_lights=_group(
            [] if parity else parsed.directional_lights,
            ("direction", "colour"), dtype, device),
        fog=_group(fog, ("center", "radius", "albedo", "scattering",
                         "absorption"), dtype, device),
        ambient=t(parsed.ambient), background=t(parsed.background),
        camera=dict(position=t(pos), direction=t(direction), up=t(up)),
        fog_zeroed=parity and bool(fog), width=parsed.width,
        height=parsed.height)
