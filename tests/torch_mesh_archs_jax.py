"""The JAX side of ``tests/test_torch_mesh_archs.py``, run in a subprocess
with 4 forced host devices (they must not leak into the rest of the suite).

    python tests/torch_mesh_archs_jax.py IN OUT

IN is a pickle of ``{arch: {"params", "blocks", "stubs"}}`` (numpy): for
each arch, its reduced config's jitted train step (remat "none") on a (2, 2)
("data", "model") mesh, the parameters and a fresh AdamW state laid out by
``ShardingRules.param_specs`` and each batch (a token block (B, S + 1) and
the frontend stubs) by ``ShardingRules.batch_specs``, as ``batch_structs``
lays them out; one step a block, the state carried. OUT gets each step's
loss, nll, aux and grad norm, and the expert leaves' shard rows.
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
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models.sharding import ShardingRules  # noqa: E402
from repro.optim import adamw_init  # noqa: E402


def place(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def steps(arch, inp, mesh):
    cfg = reduced_config(arch)
    rules = ShardingRules(cfg, mesh)
    _, train_step = make_train_step(cfg, remat="none")
    jit_step = jax.jit(train_step)
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt = adamw_init(params)
    params = place(params, rules.param_specs(params), mesh)
    opt = {"m": place(opt["m"], rules.param_specs(opt["m"]), mesh),
           "v": place(opt["v"], rules.param_specs(opt["v"]), mesh), "count": opt["count"]}
    out = {k: [] for k in ("loss", "nll", "aux", "grad_norm")}
    with use_mesh(mesh):
        for i, block in enumerate(inp["blocks"]):
            batch = {"tokens": block[:, :-1], "labels": block[:, 1:], **inp["stubs"]}
            batch = place(batch, rules.batch_specs(batch, block.shape[0]), mesh)
            params, opt, m = jit_step(params, opt, batch, jnp.asarray(i))
            for k in out:
                out[k].append(float(m[k]))
    rows = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", str(k)) for k in path]
        if len(keys) > 1 and keys[-2] == "moe" and keys[-1] in ("w_up", "w_gate", "w_down"):
            shard = leaf.addressable_shards[0].data
            rows["/".join(keys)] = shard.shape[1 if keys[0] == "stack" else 0]
    out["experts"] = rows
    return out


def main():
    inp_path, out_path = sys.argv[1:3]
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    out = {arch: steps(arch, case, mesh) for arch, case in inp.items()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print("TORCH_MESH_ARCHS_JAX_OK")


if __name__ == "__main__":
    main()
