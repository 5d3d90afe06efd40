"""Writers of the files the port reads from other implementations, with no
JAX: the original torch implementation's `dalle.pt` and `vae.pt` (the
inverse of `models/torch_port.py`'s converters, from a JAX-layout tree),
and the JAX package's pre-v3 checkpoints, whose tree structure is a
pickled `PyTreeDef` (written here opcode by opcode, so that a machine
without JAX can write one; the tests check the bytes against JAX's own
pickle).  `chip_smoke.py` imports them on the card's machine."""
import json
import pickle

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.transformer import derive_layer_specs


def _t(x) -> torch.Tensor:
    return x.detach().clone() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# the reference's state dicts
# ---------------------------------------------------------------------------


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["w"]).t().contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _conv(sd, prefix, p, transpose=False):
    w = _t(p["w"])  # HWIO, or the flipped HWIO of a transposed conv
    sd[f"{prefix}.weight"] = (w.flip(0, 1).permute(2, 3, 0, 1) if transpose else w.permute(3, 2, 0, 1)).contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def reference_dalle_state_dict(params: dict, cfg, vae_state=None, fn_links: int = 2) -> dict:
    """A JAX-layout DALL-E tree -> the reference DALLE's state dict for
    `cfg` (sequential or reversible containers, shared ids written at each
    layer, sandwich norms, tied embeddings as `to_logits.1` aliases), with
    `fn_links` parameter-free `fn` links around each branch, `vae_state`
    under `vae.*` and the `logits_mask` buffer."""
    sd = {}
    specs = derive_layer_specs(cfg.transformer_config())
    tp = params["transformer"]
    reversible = cfg.resolved_execution == "reversible"
    for spec, layer in zip(specs, tp["layers"]):
        i = spec.index
        for branch, kind in ((0, "attn"), (1, "ff")):
            if reversible:
                pre, fn = f"transformer.layers.blocks.{i}.{'fg'[branch]}.net", ".fn"
            else:
                pre, fn = f"transformer.layers.layers.{i}.{branch}", ".fn"
            sd[f"{pre}.scale"] = _t(layer[f"{kind}_scale"])
            sd[f"{pre}{fn}.norm.weight"] = _t(layer[f"{kind}_norm"]["scale"])
            sd[f"{pre}{fn}.norm.bias"] = _t(layer[f"{kind}_norm"]["bias"])
            if cfg.sandwich_norm:
                sd[f"{pre}{fn}.norm_out.weight"] = _t(layer[f"{kind}_norm_out"]["scale"])
                sd[f"{pre}{fn}.norm_out.bias"] = _t(layer[f"{kind}_norm_out"]["bias"])
            body = pre + fn + ".fn" * fn_links
            if kind == "attn":
                attn = tp["shared_attn"][spec.attn_id]
                w = _t(attn["qkv"]["w"])  # (dim, heads * 3 * dim_head), head-major
                w = w.reshape(w.shape[0], cfg.heads, 3, cfg.dim_head).transpose(1, 2).reshape(w.shape[0], -1)
                sd[f"{body}.to_qkv.weight"] = w.t().contiguous()
                _linear(sd, f"{body}.to_out.0", attn["out"])
            else:
                ff = tp["shared_ff"][spec.ff_id]
                w1 = {k: torch.cat([_t(ff["w1"][k]), _t(ff["w1g"][k])], dim=-1) for k in ff["w1"]}
                _linear(sd, f"{body}.net.0", w1)
                _linear(sd, f"{body}.net.3", ff["w2"])
    sd["to_logits.0.weight"] = _t(params["logits_norm"]["scale"])
    sd["to_logits.0.bias"] = _t(params["logits_norm"]["bias"])
    _linear(sd, "to_logits.1", params["logits_linear"])
    if cfg.share_input_output_emb:
        sd["text_emb.linear.weight"] = sd["to_logits.1.weight"]
        sd["image_emb.linear.weight"] = sd["to_logits.1.weight"]
    else:
        sd["text_emb.weight"] = _t(params["text_emb"]["table"])
        sd["image_emb.weight"] = _t(params["image_emb"]["table"])
    if not cfg.rotary_emb:
        fmap, dim = cfg.image_fmap_size, cfg.dim
        sd["text_pos_emb.weight"] = _t(params["text_pos"]["table"])
        sd["image_pos_emb.weights.0"] = _t(params["image_pos_h"]["table"]).reshape(1, fmap, 1, dim)
        sd["image_pos_emb.weights.1"] = _t(params["image_pos_w"]["table"]).reshape(1, 1, fmap, dim)
    sd["logits_mask"] = torch.zeros(1, cfg.total_seq_len, cfg.total_tokens, dtype=torch.bool)
    for key, value in (vae_state or {}).items():
        sd[f"vae.{key}"] = value
    return sd


def reference_vae_state_dict(params: dict, cfg) -> dict:
    """A JAX-layout DiscreteVAE tree -> the reference DiscreteVAE's state
    dict (its encoder and decoder `Sequential` indices)."""
    L, R = cfg.num_layers, cfg.num_resnet_blocks
    sd = {"codebook.weight": _t(params["codebook"]["table"])}
    for i, p in enumerate(params["enc_convs"]):
        _conv(sd, f"encoder.{i}.0", p)
    for j, block in enumerate(params["enc_res"]):
        for c, n in (("c1", 0), ("c2", 2), ("c3", 4)):
            _conv(sd, f"encoder.{L + j}.net.{n}", block[c])
    _conv(sd, f"encoder.{L + R}", params["enc_out"])
    first = 1 + R if R else 0
    if R:
        _conv(sd, "decoder.0", params["dec_in"])
    for j, block in enumerate(params["dec_res"]):
        for c, n in (("c1", 0), ("c2", 2), ("c3", 4)):
            _conv(sd, f"decoder.{1 + j}.net.{n}", block[c])
    for i, p in enumerate(params["dec_deconvs"]):
        _conv(sd, f"decoder.{first + i}.0", p, transpose=True)
    _conv(sd, f"decoder.{first + L}", params["dec_out"])
    return sd


def reference_hparams(cfg) -> dict:
    """The reference's `dalle_params` of a `DALLEConfig` (its image side
    comes from the VAE)."""
    keys = ("num_text_tokens", "text_seq_len", "dim", "depth", "heads", "dim_head", "reversible", "loss_img_weight",
            "attn_types", "ff_dropout", "attn_dropout", "stable", "shift_tokens", "rotary_emb", "shared_attn_ids",
            "shared_ff_ids", "share_input_output_emb", "sandwich_norm")
    return {k: getattr(cfg, k) for k in keys}


def write_reference_dalle(path, params: dict, cfg, vae_class_name: str, vae_params_meta, vae_state: dict,
                          epoch: int = 3) -> None:
    """A reference `train_dalle.py` checkpoint: hparams, vae_params,
    vae_class_name, epoch, version and the weights with the VAE under
    `vae.*`."""
    torch.save({"hparams": reference_hparams(cfg), "vae_params": vae_params_meta, "vae_class_name": vae_class_name,
                "epoch": epoch, "version": "1.6.6", "weights": reference_dalle_state_dict(params, cfg, vae_state)},
               str(path))


# ---------------------------------------------------------------------------
# the JAX package's pre-v3 checkpoints
# ---------------------------------------------------------------------------


def _nodes(tree, out):
    """`tree`'s PyTreeDef node tuples, post-order: (kind, arity, node_data,
    None, leaves below, nodes below); kinds 0 leaf, 1 None, 2 tuple, 4
    list, 5 dict (keys sorted)."""
    if tree is None:
        out.append((1, 0, None, None, 0, 1))
        return 0, 1
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else None
        children = [tree[k] for k in keys] if keys is not None else list(tree)
        leaves = nodes = 0
        for child in children:
            n_leaves, n_nodes = _nodes(child, out)
            leaves, nodes = leaves + n_leaves, nodes + n_nodes
        kind = 5 if keys is not None else (4 if isinstance(tree, list) else 2)
        out.append((kind, len(children), keys, None, leaves, nodes + 1))
        return leaves, nodes + 1
    out.append((0, 0, None, None, 1, 1))
    return 1, 1


def treedef_pickle(tree) -> bytes:
    """The bytes `pickle.dumps(jax.tree_util.tree_structure(tree))` holds
    for a tree of dicts, lists, tuples and None: `PyTreeDef()` built with
    the state (the default registry, its node tuples)."""
    nodes = []
    _nodes(tree, nodes)
    body = pickle.dumps(nodes, protocol=2)[2:-1]  # the list, without PROTO and STOP
    return (b"\x80\x02" + b"cjaxlib._jax.pytree\nPyTreeDef\n" + b")\x81" +
            b"cjax._src.tree_util\ndefault_registry\n" + body + b"\x86b.")


def _flatten(tree, out):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)


def _stored(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def write_legacy_checkpoint(path, trees: dict, meta: dict, fmt: int = 2) -> None:
    """A v1 (no format stamp) or v2 file: per tree its pickled treedef
    (`__treedef_<name>`), leaves `<name>:<i>` and the dtype sidecar."""
    payload = {"__meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    if fmt >= 2:
        payload["__format"] = np.array(fmt, dtype=np.int64)
    for name, tree in trees.items():
        leaves = []
        _flatten(tree, leaves)
        stored = [_stored(leaf) for leaf in leaves]
        payload[f"__treedef_{name}"] = np.frombuffer(treedef_pickle(tree), dtype=np.uint8)
        payload[f"__dtypes_{name}"] = np.frombuffer(json.dumps([d for _, d in stored]).encode(), dtype=np.uint8)
        for i, (arr, _) in enumerate(stored):
            payload[f"{name}:{i}"] = arr
    with open(path, "wb") as f:
        np.savez(f, **payload)
