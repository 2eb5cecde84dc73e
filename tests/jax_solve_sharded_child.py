"""The JAX package's solve_sharded on 8 virtual CPU devices, for
tests/test_torch_parallel.py, which holds the port's against it.

    python tests/jax_solve_sharded_child.py <out.npz>

It imports JAX (and not torch) first, then reads the path of the problem
(an .npz of cams0, pts0, K, dist and the observations) from one line of
its standard input, so the parent builds the problem while JAX loads. It
solves with BAConfig(max_iters=8) and writes cameras, points and mre to
out.npz. The parent sets JAX_PLATFORMS=cpu and XLA_FLAGS for 8 devices.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from imageanalysis_tpu.ba import bundle as jb
from imageanalysis_tpu.parallel import sharded as jsh


def main():
    jax.config.update("jax_platforms", "cpu")
    mesh = jsh.make_mesh(jax.devices()[:8])
    p = np.load(sys.stdin.readline().strip())
    obs = jb.BAObservations(*(jnp.asarray(p[k]) for k in
                              ("cam_idx", "pt_idx", "uv", "weight")))
    r = jsh.solve_sharded(p["cams0"], p["pts0"], obs, jnp.asarray(p["K"]),
                          jnp.asarray(p["dist"]), mesh,
                          jb.BAConfig(max_iters=8), verbose=False)
    np.savez(sys.argv[1], cams=r.cams, pts=r.pts, mre=r.mre)


if __name__ == "__main__":
    main()
