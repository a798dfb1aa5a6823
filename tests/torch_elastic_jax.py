"""The JAX side of ``tests/test_torch_elastic.py``'s parity tests, run in a
subprocess with 8 forced host devices (they must not leak into the rest
of the suite).

    python tests/torch_elastic_jax.py steps IN OUT CKPT
        The reference elastic helpers' reduced granite_8b on a (1, 8)
        ("data", "model") mesh laid out by ``ShardingRules``: one jitted
        train step per token block of IN (a pickle: ``params`` as numpy,
        ``blocks``), from ``params`` and a fresh AdamW state. OUT gets
        each step's loss and the state before each step (numpy); the state
        after the last step is checkpointed (sharded, step 3) into CKPT.
    python tests/torch_elastic_jax.py restore IN OUT CKPT
        The checkpoint in CKPT (step 5, written by the port's ranks)
        restored onto a (1, 4) mesh laid out by ``ShardingRules``; OUT gets
        the restored state (numpy) and each restored leaf's device count.

The mesh's axes are Auto-typed (``compat_make_mesh``), as the reference's
launchers build it.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.checkpoint import Checkpointer  # noqa: E402
from repro.configs import reduced_config  # noqa: E402
from repro.launch.mesh import compat_make_mesh, use_mesh  # noqa: E402
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models.sharding import ShardingRules  # noqa: E402
from repro.optim import adamw_init  # noqa: E402


def elastic_cfg():
    return dataclasses.replace(reduced_config("granite_8b"), n_layers=2, d_model=64,
                               d_ff=128, vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=16)


def state_specs(cfg, mesh, tree):
    rules = ShardingRules(cfg, mesh)
    return {"params": rules.param_specs(tree["params"]),
            "opt": {"m": rules.param_specs(tree["opt"]["m"]),
                    "v": rules.param_specs(tree["opt"]["v"]), "count": P()}}


def place(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def steps(inp, ckpt_dir):
    cfg = elastic_cfg()
    _, train_step = make_train_step(cfg, remat="none")
    jit_step = jax.jit(train_step)
    mesh = compat_make_mesh((1, 8), ("data", "model"))
    params = jax.tree.map(jnp.asarray, inp["params"])
    tree = {"params": params, "opt": adamw_init(params)}
    tree = place(tree, state_specs(cfg, mesh, tree), mesh)
    states, losses = [], []
    with use_mesh(mesh):
        for i, block in enumerate(inp["blocks"]):
            states.append(jax.tree.map(np.asarray, tree))
            rep = NamedSharding(mesh, P())
            batch = {"tokens": jax.device_put(block[:, :-1], rep),
                     "labels": jax.device_put(block[:, 1:], rep)}
            p, o, m = jit_step(tree["params"], tree["opt"], batch, jnp.asarray(i))
            tree = {"params": p, "opt": o}
            losses.append(float(m["loss"]))
        Checkpointer(ckpt_dir, async_save=False).save(3, tree, wait=True)
    n_shards = len(tree["params"]["embed"].addressable_shards)
    return {"losses": losses, "states": states, "final": jax.tree.map(np.asarray, tree),
            "embed_shards": n_shards}


def restore(inp, ckpt_dir):
    cfg = elastic_cfg()
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), inp["expected"])
    specs = state_specs(cfg, mesh, shapes)
    structs = jax.tree.map(lambda s, sp: jax.ShapeDtypeStruct(
        s.shape, s.dtype, sharding=NamedSharding(mesh, sp)), shapes, specs,
        is_leaf=lambda x: isinstance(x, P))
    back = Checkpointer(ckpt_dir).restore(5, structs)
    return {"restored": jax.tree.map(np.asarray, back),
            "devices": jax.tree.map(lambda x: len(x.sharding.device_set), back)}


def main():
    what, inp_path, out_path, ckpt_dir = sys.argv[1:5]
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = steps(inp, ckpt_dir) if what == "steps" else restore(inp, ckpt_dir)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print("TORCH_ELASTIC_JAX_OK")


if __name__ == "__main__":
    main()
