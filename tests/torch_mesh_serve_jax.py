"""The JAX side of ``tests/test_torch_mesh_serve.py``, run in a subprocess
with 4 forced host devices (they must not leak into the rest of the suite).

    python tests/torch_mesh_serve_jax.py IN OUT

IN is a pickle of a list of cases ``(key, arch, mesh_shape, params, tokens,
stubs, gen)`` (numpy): for each, the reduced config's jitted prefill and
``gen`` greedy jitted decode steps on a ("data", "model") mesh of
``mesh_shape``, the parameters laid out by ``ShardingRules.param_specs``,
the cache (sized with the VLM's patches) by ``cache_specs``, and the
prompt, each step's ``pos`` and the frontend stubs by ``batch_specs``, as
``serve_structs`` lays them out. OUT gets, by ``key``, each step's
last-position logits (B, V), the greedy tokens and each cache leaf's
layout before the prefill (tensor dim -> mesh axes).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import pickle  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.launch.mesh import compat_make_mesh, use_mesh  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.sharding import ShardingRules  # noqa: E402


def place(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def axes_by_dim(spec) -> dict:
    """tensor dim -> the mesh axes that shard it, of a ``PartitionSpec``."""
    out = {}
    for i, e in enumerate(spec):
        names = [e] if isinstance(e, str) else list(e or ())
        if names:
            out[i] = names
    return out


def serve(arch, mesh_shape, params, tokens, stubs, gen):
    cfg = reduced_config(arch)
    model = build_model(cfg)
    mesh = compat_make_mesh(mesh_shape, ("data", "model"))
    rules = ShardingRules(cfg, mesh)
    B, S = tokens.shape
    off = cfg.n_patches if cfg.vision_stub else 0
    params = jax.tree.map(jnp.asarray, params)
    params = place(params, rules.param_specs(params), mesh)
    cache = model.init_cache(B, off + S + gen)
    cache = place(cache, rules.cache_specs(cache, B), mesh)
    specs = {"/".join(str(getattr(k, "key", k)) for k in path): axes_by_dim(leaf.sharding.spec)
             for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]}
    plain = {"tokens": tokens, "extras": stubs}
    plain = place(plain, rules.batch_specs(plain, B), mesh)
    prefill = jax.jit(lambda p, t, c, e: model.prefill(p, t, c, **e))
    decode = jax.jit(model.decode)
    logits_out, toks = [], []
    with use_mesh(mesh):
        logits, cache = prefill(params, plain["tokens"], cache, plain["extras"])
        for i in range(gen + 1):
            logits_out.append(np.asarray(logits[:, -1], np.float32))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            if i == gen:
                break
            step = place({"token": np.asarray(tok), "pos": np.full((B,), off + S + i, np.int32)},
                         rules.batch_specs({"token": tok, "pos": np.zeros((B,), np.int32)}, B),
                         mesh)
            logits, cache = decode(params, step["token"], cache, step["pos"])
    return {"logits": logits_out, "tokens": np.concatenate(toks, axis=1), "specs": specs}


def main():
    inp_path, out_path = sys.argv[1:3]
    with open(inp_path, "rb") as f:
        cases = pickle.load(f)
    out = {key: serve(*rest) for key, *rest in cases}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print("TORCH_MESH_SERVE_JAX_OK")


if __name__ == "__main__":
    main()
