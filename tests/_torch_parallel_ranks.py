"""The rank side of tests/test_torch_parallel.py: the golden file's
inputs, each sharded transform and step on a rank's blocks, the port's
local steps, and `rank_checks`, the function launch.run runs on every
rank.  It imports no pytest, so that the ranks, forked from a server
that preloaded torch and the port, start at once."""

import os

import numpy as np
import torch

from phantom_tpu_torch import make_context
from phantom_tpu_torch.host.ntt_tables import make_rns_ntt_tables
from phantom_tpu_torch.ops import ntt as ntt64
from phantom_tpu_torch.ops import ntt32
from phantom_tpu_torch.ops import pipeline32 as pp
from phantom_tpu_torch.parallel import mesh as pm
from phantom_tpu_torch.parallel import ntt_sharded as ns
from phantom_tpu_torch.parallel import pipeline_sharded as psh
from phantom_tpu_torch.parallel import sharded32 as s32
from phantom_tpu_torch.schemes import evaluate as ev
from phantom_tpu_torch.schemes.ciphertext import Ciphertext
from phantom_tpu_torch.schemes.params import EncryptionParameters

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "torch_port", "sharded_n1024.npz")
NTTS = ("ntt32_fwd", "ntt32_inv", "ntt32_inv_scaled", "ntt64_fwd",
        "ntt64_inv")
STEPS = ("s32", "ckks", "bgv", "bfv")


def _u32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32))


def _u64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).view(np.int64))


def _ntt_inputs(g):
    """(tables, input) of the u32 transforms, then of the u64 ones."""
    n = g["x32"].shape[-1]
    t32 = ntt32.NTTTables32(make_rns_ntt_tables(
        n, g["data_moduli"].tolist()))
    t64 = ntt64.NTTTables64(make_rns_ntt_tables(n, g["q64"].tolist()))
    return t32, _u32(g["x32"]), t64, _u64(g["x64"])


def sharded_ntts(mesh, g) -> dict:
    """Each golden transform's rank block."""
    t32, x32, t64, x64 = _ntt_inputs(g)
    st32, st64 = ns.prepare_sharded_tables32(t32), \
        ns.prepare_sharded_tables(t64)
    b32, b64 = pm.shard_coeff(x32, mesh), pm.shard_coeff(x64, mesh)
    return {
        "ntt32_fwd": ns.ntt_forward_sharded3(b32, st32, mesh),
        "ntt32_inv": ns.ntt_inverse_sharded3(b32, st32, mesh),
        "ntt32_inv_scaled": ns.ntt_inverse_sharded3(
            b32, st32, mesh, scale=_u32(g["scale32"]),
            scale_shoup=_u32(g["scale32_shoup"])),
        "ntt64_fwd": ns.ntt_forward_sharded3(b64, st64, mesh),
        "ntt64_inv": ns.ntt_inverse_sharded3(b64, st64, mesh),
    }


def _ctx(g, name):
    n = g["x32"].shape[-1]
    if name == "s32":
        return make_context(EncryptionParameters.create(
            n, g["data_moduli"].tolist(), g["special_moduli"].tolist()),
            device="cpu")
    t = {} if name == "ckks" else dict(scheme=name,
                                       plain_modulus=int(g["t"]))
    return make_context(EncryptionParameters.create(
        n, g["u64_data"].tolist(), g["u64_special"].tolist(), **t),
        device="cpu")


def _step_inputs(g, name):
    conv = _u32 if name == "s32" else _u64
    return (conv(g[f"{name}_d1"]), conv(g[f"{name}_d2"]),
            conv(g[f"{name}_rlk"]))


def sharded_step(mesh, g, name, d1, d2, rlk):
    """One sharded step of STEPS on the rank's blocks of d1, d2."""
    ctx = _ctx(g, name)
    b1, b2 = pm.shard_coeff(d1, mesh), pm.shard_coeff(d2, mesh)
    if name == "s32":
        c = s32.build_sharded32(ctx, rlk, mesh)
        return s32.sharded_mult_relin_rescale32(c, mesh, b1, b2)
    if name == "bfv":
        return psh.sharded_bfv_mult_relin(
            psh.build_bfv_sharded_consts(ctx, rlk, mesh), mesh, b1, b2)
    c = psh.build_sharded_consts(ctx, rlk, mesh)
    fn = (psh.sharded_mult_relin_rescale if name == "ckks"
          else psh.sharded_bgv_mult_relin_modswitch)
    return fn(c, mesh, b1, b2)


def local_step(g, name, d1, d2, rlk):
    """The port's local step on the whole operands."""
    ctx = _ctx(g, name)
    if name == "s32":
        return pp.mult_relin_rescale32(
            pp.build_pipeline32(ctx, rlk, device="cpu",
                                modup="xla-split"), d1, d2)
    c1, c2 = (Ciphertext(x, chain_index=1, is_ntt_form=name != "bfv")
              for x in (d1, d2))
    out = ev.multiply_and_relin(ctx, c1, c2, rlk)
    if name == "ckks":
        out = ev.rescale_to_next(ctx, out)
    elif name == "bgv":
        out = ev.mod_switch_to_next(ctx, out)
    return out.data


def rank_checks(mesh, path) -> dict:
    """launch.run's function: this rank's blocks of every transform and
    step (numpy), with its mesh indices, and the u64 forward gathered
    whole (gather_coeff); on four ranks also the dp = 2 x coeff = 2
    mesh's batched steps (build_sharded_step32, build_sharded_step on the
    context's scheme), items (d1, d2) and (d1, d1)."""
    g = np.load(path)
    ntts = sharded_ntts(mesh, g)
    out = {k: v.numpy() for k, v in ntts.items()}
    for name in STEPS:
        out[name] = sharded_step(mesh, g, name,
                                 *_step_inputs(g, name)).numpy()
    res = dict(coeff_index=mesh.coeff_index, out=out,
               gathered=pm.gather_coeff(ntts["ntt64_fwd"], mesh).numpy())
    if mesh.world == 4:
        m2 = pm.make_coeff_mesh(dp=2)
        res.update(dp_index=m2.dp_index, dp_coeff_index=m2.coeff_index)
        for name in STEPS:
            d1, d2, rlk = _step_inputs(g, name)
            ctx = _ctx(g, name)
            b1 = pm.shard_batch(torch.stack([d1, d1]), m2)
            b2 = pm.shard_batch(torch.stack([d2, d1]), m2)
            build = (s32.build_sharded_step32 if name == "s32"
                     else psh.build_sharded_step)
            _, step = build(ctx, rlk, m2)
            res[f"dp_{name}"] = step(b1, b2).numpy()
    return res


def limb_rank_checks(mesh) -> dict:
    """launch.run's function for the ("dp", "limb") layout: this rank's
    outputs of limb_n1024.npz's configurations on its mesh (chip_smoke.
    limb_golden), with its indices; on four ranks also on the dp = 2 x
    limb = 2 mesh of the same world."""
    import chip_smoke
    res = dict(mesh=(mesh.dp, mesh.limb, mesh.dp_index, mesh.limb_index),
               out=chip_smoke.limb_golden(mesh))
    if mesh.world == 4:
        m2 = pm.make_mesh(4, dp=2, limb=2)
        res.update(mesh2=(m2.dp, m2.limb, m2.dp_index, m2.limb_index),
                   out2=chip_smoke.limb_golden(m2))
    return res
