"""Checkpoints: funasr encoders, reference checkpoints and train states.

Counterpart of the import half of ``ps_slm_tpu/training/checkpoint.py``
and the exporter the tests and ``chip_smoke.py`` write files with:

  * :func:`load_funasr_encoder`: a funasr SenseVoiceSmall directory
    (``model.pt`` + ``config.yaml``) -> a ``SenseVoiceEncoder`` state dict
    and its config;
  * :func:`export_reference_checkpoint` / :func:`import_reference_checkpoint`:
    the composite ``pytorch_model.bin`` of the reference (``llm.*``,
    ``encoder.*``, ``encoder_projector.*``), fp32 on export; on import each
    tensor is cast once into the model's parameter (``load_state_dict``
    copies into the parameter's dtype and device), and the llm and the
    encoder each load whole or raise ``KeyError("partial ... checkpoint")``
    (the projector loads the keys it finds, as in the JAX package); a
    quantized LLM exports its dequantized kernels (bf16-rounded, as the
    JAX exporter) and re-quantizes imported ones with its own scheme; LoRA
    is folded into the exported kernels, and an import keeps the model's
    adapters;
  * :func:`export_peft_adapters` / :func:`import_peft_adapters`: the
    adapters in the HF-PEFT layout (``adapter_model.bin`` and
    ``adapter_config.json``), the finetune CLI's ``adapter/`` export and
    its ``peft_ckpt``;
  * every projector's reference key map (:func:`projector_to_reference`,
    :func:`reference_to_projector`), the q-former's in HF Blip2QFormer
    names, and :func:`load_ctc_linear`, a pretrained CTC head for the
    simple_linear projector;
  * :func:`save_train_state` / :func:`restore_train_state`: the whole
    state of a training run (every parameter, AdamW's state, the
    accumulated gradients, the micro-step count and the generator), as the
    JAX package's Orbax train states hold it, so ``resume_from`` alone
    restores the run.  The JAX package writes Orbax, which this package
    does not read; the two hand weights to each other through the
    reference ``pytorch_model.bin``.

Files are read with ``torch.load(weights_only=True)``: state dicts of
tensors, never arbitrary pickles.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple, Union

import torch

from ps_slm_tpu_torch.models import quantization, qwen2
from ps_slm_tpu_torch.models.lora import BLOCK_LEAVES, LORA_LEAVES
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig

StateDict = Dict[str, torch.Tensor]
# a Qwen2Model's PEFT entries (models/lora.py), parameters and buffers
_ADAPTER_STATE = LORA_LEAVES + BLOCK_LEAVES


# ----------------------------------------------------------------------------
# external assets
# ----------------------------------------------------------------------------

def _torch_load_state(path: str) -> StateDict:
    """The tensors of a torch checkpoint (a state dict, or one under
    ``"model"`` / ``"state_dict"``), as stored."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _parse_encoder_yaml(path: str) -> dict:
    """funasr ``config.yaml``: ``encoder_conf`` plus the top-level
    ``input_size`` (default 560) and ``vocab_size`` (default 25 055).  With
    PyYAML when it is installed, else a reader of the subset funasr writes
    (top-level scalars and one level of section scalars)."""
    try:
        import yaml  # type: ignore
    except ImportError:
        yaml = None
    if yaml is not None:
        with open(path) as f:
            full = yaml.safe_load(f)
        conf = dict(full.get("encoder_conf", {}))
        conf["input_size"] = full.get("input_size", conf.get("input_size", 560))
        conf["vocab_size"] = full.get("vocab_size", 25055)
        return conf

    def parse(v):
        try:
            return json.loads(v)
        except json.JSONDecodeError:
            return v

    conf: dict = {}
    top: dict = {}
    section = None
    with open(path) as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            indent = len(line) - len(line.lstrip())
            m = re.match(r"([\w_]+):\s*(.*)", line.strip())
            if not m:
                continue
            key, val = m.groups()
            if indent == 0:
                section = key if val == "" else None
                if val != "":
                    top[key] = parse(val)
                continue
            if section == "encoder_conf" and val != "":
                conf[key] = parse(val)
    conf["input_size"] = top.get("input_size", conf.get("input_size", 560))
    conf["vocab_size"] = top.get("vocab_size", 25055)
    return conf


# funasr EncoderLayerSANM names -> the port's SANMLayer names
_SANM_KEYS = {
    "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
    "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
    "self_attn.linear_q_k_v.weight": "qkv.weight",
    "self_attn.linear_q_k_v.bias": "qkv.bias",
    "self_attn.linear_out.weight": "out.weight",
    "self_attn.linear_out.bias": "out.bias",
    "self_attn.fsmn_block.weight": "fsmn.weight",     # depthwise conv [C, 1, k]
    "feed_forward.w_1.weight": "w1.weight", "feed_forward.w_1.bias": "w1.bias",
    "feed_forward.w_2.weight": "w2.weight", "feed_forward.w_2.bias": "w2.bias",
}
_ENC_TOP_KEYS = {
    "encoder.after_norm.weight": "after_norm.weight",
    "encoder.after_norm.bias": "after_norm.bias",
    "encoder.tp_norm.weight": "tp_norm.weight",
    "encoder.tp_norm.bias": "tp_norm.bias",
    "ctc.ctc_lo.weight": "ctc_lo.weight",
    "ctc.ctc_lo.bias": "ctc_lo.bias",
    "embed.weight": "query_embed",
}


def _encoder_layers(cfg: SenseVoiceConfig):
    """(funasr prefix, port prefix) of every SANM layer."""
    yield "encoder.encoders0.0", "encoders0"
    for i in range(cfg.num_blocks - 1):
        yield f"encoder.encoders.{i}", f"encoders.{i}"
    for i in range(cfg.tp_blocks):
        yield f"encoder.tp_encoders.{i}", f"tp_encoders.{i}"


def funasr_to_state_dict(tensors: StateDict, cfg: SenseVoiceConfig, consumed=None) -> StateDict:
    """A funasr SenseVoiceSmall state dict -> a ``SenseVoiceEncoder`` state
    dict, tensors as they are (both store torch layouts).  A name is also
    found without its leading ``encoder.``; ``KeyError`` on a missing one;
    ``consumed`` receives the names read."""
    def get(name):
        for cand in (name, name.replace("encoder.", "", 1)):
            if cand in tensors:
                if consumed is not None:
                    consumed.add(cand)
                return tensors[cand]
        raise KeyError(name)

    out: StateDict = {}
    for src, dst in _encoder_layers(cfg):
        for k, ours in _SANM_KEYS.items():
            out[f"{dst}.{ours}"] = get(f"{src}.{k}")
    for k, ours in _ENC_TOP_KEYS.items():
        out[ours] = get(k)
    return out


def _encoder_to_reference(encoder) -> StateDict:
    """Inverse of :func:`funasr_to_state_dict`, nested under ``encoder.``
    as in the reference checkpoint (its ``encoder`` is the funasr
    SenseVoiceSmall module); fp32 CPU tensors."""
    sd = encoder.state_dict()
    out: StateDict = {}
    for src, dst in _encoder_layers(encoder.cfg):
        for k, ours in _SANM_KEYS.items():
            out[f"encoder.{src}.{k}"] = sd[f"{dst}.{ours}"]
    for k, ours in _ENC_TOP_KEYS.items():
        out[f"encoder.{k}"] = sd[ours]
    return {k: v.detach().float().cpu().contiguous() for k, v in out.items()}


def load_funasr_encoder(path: str, **overrides) -> Tuple[StateDict, SenseVoiceConfig]:
    """A funasr SenseVoiceSmall directory (``model.pt``, ``model.pb`` or
    ``pytorch_model.bin``, and ``config.yaml``) -> (state dict as stored,
    config); ``overrides`` take precedence over ``config.yaml``."""
    conf: dict = {}
    ypath = os.path.join(path, "config.yaml")
    if os.path.exists(ypath):
        raw = _parse_encoder_yaml(ypath)
        for k in ("input_size", "output_size", "attention_heads", "linear_units",
                  "num_blocks", "tp_blocks", "kernel_size", "sanm_shift", "vocab_size"):
            if k in raw:
                conf[k] = int(raw[k])
    conf.update(overrides)
    cfg = SenseVoiceConfig(**conf)
    for cand in ("model.pt", "model.pb", "pytorch_model.bin"):
        mpath = os.path.join(path, cand)
        if os.path.exists(mpath):
            return funasr_to_state_dict(_torch_load_state(mpath), cfg), cfg
    raise FileNotFoundError(f"no model.pt under {path}")


# ----------------------------------------------------------------------------
# reference-format interchange (pytorch_model.bin key layout)
# ----------------------------------------------------------------------------

def load_ctc_linear(path: str) -> StateDict:
    """A pretrained CTC head (``ctc_head.weight`` [V, D], ``ctc_head.bias``)
    as the simple_linear projector's state dict (``map.*``)."""
    state = _torch_load_state(path)
    return {"map.weight": state["ctc_head.weight"], "map.bias": state["ctc_head.bias"]}


# the port's projector names -> the reference module's (both torch layouts,
# so no tensor is transposed)
_PROJ_KEYMAPS = {
    "simple_linear": {"map.weight": "map.weight", "map.bias": "map.bias"},
    "linear": {
        "linear1.weight": "linear1.weight", "linear1.bias": "linear1.bias",
        "linear2.weight": "linear2.weight", "linear2.bias": "linear2.bias",
    },
    "cov1d-linear": {
        "conv.weight": "conv1d.weight", "conv.bias": "conv1d.bias",
        "linear1.weight": "linear1.weight", "linear1.bias": "linear1.bias",
        "linear2.weight": "linear2.weight", "linear2.bias": "linear2.bias",
    },
    "linear-silu": {
        "norm.weight": "norm.weight", "norm.bias": "norm.bias",
        "ffn1.weight": "ffn.0.weight", "ffn1.bias": "ffn.0.bias",
        "ffn2.weight": "ffn.2.weight", "ffn2.bias": "ffn.2.bias",
    },
    "cross-attention": {"w_q.weight": "W_q.weight"},
}

# a QFormerLayer's names -> the HF Blip2QFormerLayer's, under
# ``qformer.encoder.layer.{i}.``; the cross-attention entries on the
# layers that have one
_QF_SELF = {
    "self_q": "attention.attention.query", "self_k": "attention.attention.key",
    "self_v": "attention.attention.value", "self_o": "attention.output.dense",
    "ln_self": "attention.output.LayerNorm",
    "ffn1": "intermediate_query.dense", "ffn2": "output_query.dense",
    "ln_ffn": "output_query.LayerNorm",
}
_QF_CROSS = {
    "cross_q": "crossattention.attention.query", "cross_k": "crossattention.attention.key",
    "cross_v": "crossattention.attention.value", "cross_o": "crossattention.output.dense",
    "ln_cross": "crossattention.output.LayerNorm",
}
_QF_TOP = {
    "query": "query",
    "ln_embed.weight": "qformer.layernorm.weight", "ln_embed.bias": "qformer.layernorm.bias",
    "out.weight": "linear.weight", "out.bias": "linear.bias",
    "out_norm.weight": "norm.weight", "out_norm.bias": "norm.bias",
}


def _qformer_keymap(projector) -> Dict[str, str]:
    keymap = dict(_QF_TOP)
    for i, layer in enumerate(projector.layers):
        names = dict(_QF_SELF, **(_QF_CROSS if layer.cross else {}))
        for ours, ref in names.items():
            for leaf in ("weight", "bias"):
                keymap[f"layers.{i}.{ours}.{leaf}"] = f"qformer.encoder.layer.{i}.{ref}.{leaf}"
    return keymap


def _projector_keymap(projector_name: str, projector=None) -> Dict[str, str]:
    if projector_name == "q-former":
        if projector is None:
            raise ValueError("the q-former's key map needs the projector (its layers)")
        return _qformer_keymap(projector)
    keymap = _PROJ_KEYMAPS.get(projector_name)
    if keymap is None:
        raise KeyError(f"unknown projector {projector_name!r}; known: "
                       f"{sorted(_PROJ_KEYMAPS) + ['q-former']}")
    return keymap


def projector_to_reference(projector, projector_name: str) -> StateDict:
    """The projector's weights under ``encoder_projector.*``, fp32 CPU."""
    sd = projector.state_dict()
    return {f"encoder_projector.{ref}": sd[ours].detach().float().cpu().contiguous()
            for ours, ref in _projector_keymap(projector_name, projector).items()}


def reference_to_projector(tensors: StateDict, projector_name: str, projector=None
                           ) -> Tuple[StateDict, List[str]]:
    """(the projector's state dict entries found under
    ``encoder_projector.*``, the reference keys read); the q-former's map
    needs ``projector``, whose layers say where the cross-attention is."""
    out, loaded = {}, []
    for ours, ref in _projector_keymap(projector_name, projector).items():
        key = f"encoder_projector.{ref}"
        if key in tensors:
            out[ours] = tensors[key]
            loaded.append(key)
    return out, loaded


def export_reference_checkpoint(model, path: str, *, exclude: tuple = ()) -> StateDict:
    """Write a reference-layout ``pytorch_model.bin`` (fp32 tensors,
    composite key names) when ``path`` is given; returns the tensors.
    ``exclude`` names whole submodules ("llm", "encoder", "projector") to
    leave out, as the reference leaves out frozen ones."""
    tensors: StateDict = {}
    if "llm" not in exclude:
        for k, v in qwen2.state_dict_to_hf(model.llm).items():
            tensors[f"llm.{k}"] = v.detach().float().cpu().contiguous()
    if "encoder" not in exclude:
        tensors.update(_encoder_to_reference(model.encoder))
    if "projector" not in exclude:
        tensors.update(projector_to_reference(model.projector, model.model_cfg.encoder_projector))
    if path:
        torch.save(tensors, path)
    return tensors


def import_reference_checkpoint(model, path_or_tensors: Union[str, StateDict]) -> List[str]:
    """Load a composite ``pytorch_model.bin`` (a path or its tensors) into
    ``model`` and return the reference keys loaded.

    Keys no module reads are left out of the list (strict=False), not
    fatal.  The llm and the encoder load whole: a checkpoint that holds
    some of a module's tensors and misses one raises
    ``KeyError("partial llm checkpoint ...")`` (or ``encoder``) before any
    of that module's weights change."""
    tensors = (_torch_load_state(path_or_tensors) if isinstance(path_or_tensors, str)
               else dict(path_or_tensors))
    loaded: List[str] = []

    llm_tensors = {k[len("llm."):]: v for k, v in tensors.items() if k.startswith("llm.")}
    if llm_tensors:
        consumed: set = set()
        try:
            state = qwen2.hf_to_state_dict(llm_tensors, model.llm.cfg, consumed=consumed)
        except KeyError as e:
            raise KeyError(f"partial llm checkpoint, missing {e}") from e
        spec = quantization.quant_spec(model.llm)
        if spec is not None:
            # keep the factory's scheme: the fresh weights in the model's
            # dtype, quantized as the JAX import re-quantizes them
            state = quantization.quantize_state_dict(
                state, *spec, dtype=model.llm.embed_tokens.weight.dtype)
        # the base weights load; the PEFT adapters (no HF name) stay
        missing, unexpected = model.llm.load_state_dict(state, strict=False)
        kept = [k for k in missing if k.rpartition(".")[2] not in _ADAPTER_STATE]
        if kept or unexpected:
            raise KeyError(f"llm checkpoint does not fit the model: missing {kept}, "
                           f"unexpected {unexpected}")
        loaded += [f"llm.{k}" for k in llm_tensors if k in consumed]

    enc_tensors = {k[len("encoder."):]: v for k, v in tensors.items()
                   if k.startswith("encoder.") and not k.startswith("encoder_projector.")}
    if enc_tensors:
        consumed = set()
        try:
            state = funasr_to_state_dict(enc_tensors, model.encoder.cfg, consumed=consumed)
        except KeyError as e:
            raise KeyError(f"partial encoder checkpoint, missing {e}") from e
        model.encoder.load_state_dict(state)
        loaded += [f"encoder.{k}" for k in enc_tensors if k in consumed]

    state, proj_loaded = reference_to_projector(tensors, model.model_cfg.encoder_projector,
                                                model.projector)
    model.projector.load_state_dict(state, strict=False)
    return loaded + proj_loaded


# ----------------------------------------------------------------------------
# HF-PEFT adapter interchange (adapter_model.bin layout)
# ----------------------------------------------------------------------------

# the port's projection name -> its HF module path inside a layer
_PEFT_MODULES = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}


def _peft_layer(i: int) -> str:
    return f"base_model.model.model.layers.{i}"


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().cpu().contiguous()


def export_peft_adapters(model, path: str) -> StateDict:
    """Write the LLM's adapters in the HF-PEFT layout into the directory
    ``path`` (when given): ``adapter_model.bin`` and
    ``adapter_config.json``, as the JAX ``export_peft_adapters``; returns
    the fp32 tensors.

    * LoRA: ``...layers.{i}.<module>.lora_{A,B}.weight`` [r, in] / [out, r],
      the raw factors; the config's ``lora_alpha`` is layer 0's scale x r.
    * prefix tuning: one ``prompt_embeddings`` [P, L * 2 * Hkv * D] in
      peft's ``get_prompt`` order (layer l's keys at 2l, values at 2l + 1).
    * llama-adapter: ``...layers.{l}.self_attn.adaption_prompt`` [1, P, H]
      and ``adaption_gate`` [1] of the adapted layers only.
    """
    layers = model.llm.layers
    tensors: StateDict = {}
    config = None
    targets, r, alpha = [], None, None
    for name, hf_mod in _PEFT_MODULES.items():
        if getattr(getattr(layers[0], name), "lora_a", None) is None:
            continue
        targets.append(name)
        first = getattr(layers[0], name)
        r = first.lora_a.shape[1]
        alpha = float(first.lora_scale.float()) * r
        for i, layer in enumerate(layers):
            lin = getattr(layer, name)
            tensors[f"{_peft_layer(i)}.{hf_mod}.lora_A.weight"] = _f32(lin.lora_a.T)
            tensors[f"{_peft_layer(i)}.{hf_mod}.lora_B.weight"] = _f32(lin.lora_b.T)
    if tensors:
        config = {
            "peft_type": "LORA", "task_type": "CAUSAL_LM", "r": int(r),
            "lora_alpha": int(alpha) if float(alpha).is_integer() else float(alpha),
            "lora_dropout": 0.0, "bias": "none", "target_modules": sorted(targets),
            "inference_mode": True,
        }
    if layers[0].prefix_k is not None:
        pk = torch.stack([_f32(layer.prefix_k) for layer in layers], dim=1)   # [P, L, Hkv, D]
        pv = torch.stack([_f32(layer.prefix_v) for layer in layers], dim=1)
        p, n, nkv, hd = pk.shape
        tensors["prompt_embeddings"] = torch.stack([pk, pv], dim=2).reshape(p, n * 2 * nkv * hd)
        config = {
            "peft_type": "PREFIX_TUNING", "task_type": "CAUSAL_LM",
            "num_virtual_tokens": int(p), "num_layers": int(n),
            "num_attention_heads": int(nkv), "token_dim": int(nkv * hd),
            "num_transformer_submodules": 1, "prefix_projection": False,
            "inference_mode": True,
        }
    if layers[0].adaption_prompt is not None:
        adapted = [i for i, layer in enumerate(layers) if float(layer.adaption_mask) != 0.0]
        for i in adapted:
            pre = f"{_peft_layer(i)}.self_attn"
            tensors[f"{pre}.adaption_prompt"] = _f32(layers[i].adaption_prompt)[None]
            tensors[f"{pre}.adaption_gate"] = _f32(layers[i].adaption_gate).reshape(1)
        config = {
            "peft_type": "ADAPTION_PROMPT", "task_type": "CAUSAL_LM",
            "adapter_len": int(layers[0].adaption_prompt.shape[0]),
            "adapter_layers": len(adapted), "target_modules": "self_attn",
            "inference_mode": True,
        }
    if path:
        os.makedirs(path, exist_ok=True)
        torch.save(tensors, os.path.join(path, "adapter_model.bin"))
        if config is not None:
            with open(os.path.join(path, "adapter_config.json"), "w") as f:
                json.dump(config, f, indent=2)
    return tensors


@torch.no_grad()
def import_peft_adapters(model, path_or_tensors: Union[str, StateDict]) -> List[str]:
    """Load an HF-PEFT adapter checkpoint (a directory holding
    ``adapter_model.bin``, the file, or its tensors) into the LLM's
    adapters, each tensor copied into its parameter's dtype; returns the
    keys loaded.  An ``adapter_config.json`` beside the weights sets every
    LoRA ``lora_scale`` to its ``lora_alpha / r``, as the JAX import does
    (the factors carry no scale)."""
    cfg_scale = None
    if isinstance(path_or_tensors, str):
        p = path_or_tensors
        cfg_path = os.path.join(p if os.path.isdir(p) else os.path.dirname(p),
                                "adapter_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                acfg = json.load(f)
            r, alpha = acfg.get("r"), acfg.get("lora_alpha")
            if r and alpha is not None:
                cfg_scale = float(alpha) / float(r)
        if os.path.isdir(p):
            p = os.path.join(p, "adapter_model.bin")
        tensors = _torch_load_state(p)
    else:
        tensors = dict(path_or_tensors)

    layers = model.llm.layers
    loaded: List[str] = []

    def put(param, key, transpose=False):
        if key in tensors:
            value = tensors[key].float()
            param.copy_(value.T if transpose else value.reshape(param.shape))
            loaded.append(key)

    for name, hf_mod in _PEFT_MODULES.items():
        for i, layer in enumerate(layers):
            lin = getattr(layer, name)
            if getattr(lin, "lora_a", None) is None:
                continue
            put(lin.lora_a, f"{_peft_layer(i)}.{hf_mod}.lora_A.weight", transpose=True)
            put(lin.lora_b, f"{_peft_layer(i)}.{hf_mod}.lora_B.weight", transpose=True)
            if cfg_scale is not None:
                lin.lora_scale.fill_(cfg_scale)
    if "prompt_embeddings" in tensors and layers[0].prefix_k is not None:
        p, nkv, hd = layers[0].prefix_k.shape
        emb = tensors["prompt_embeddings"].float().reshape(p, len(layers), 2, nkv, hd)
        for i, layer in enumerate(layers):
            layer.prefix_k.copy_(emb[:, i, 0])
            layer.prefix_v.copy_(emb[:, i, 1])
        loaded.append("prompt_embeddings")
    if layers[0].adaption_prompt is not None:
        for i, layer in enumerate(layers):
            pre = f"{_peft_layer(i)}.self_attn"
            put(layer.adaption_prompt, f"{pre}.adaption_prompt")
            put(layer.adaption_gate, f"{pre}.adaption_gate")
    return loaded


TRAIN_STATE_FILE = "train_state.pt"


def _state_file(state) -> str:
    """``train_state.pt``, or under a mesh this process's
    ``train_state.rank<r>.pt``."""
    if state.model.mesh is None:
        return TRAIN_STATE_FILE
    import torch.distributed as dist

    return f"train_state.rank{dist.get_rank()}.pt"


# a tensor another process's file holds: this marker and that rank
HELD_BY = "held by rank "


def _param_names(state) -> List[str]:
    """The names of ``state``'s optimizer parameters, in its index order."""
    ids = {id(p): n for n, p in state.model.named_parameters()}
    return [ids[id(p)] for p in state.accum.params]


def _write_once(blob: Dict, state) -> Dict:
    """``blob`` with every tensor this process does not write (another
    holds the same shard or replicated tensor: ``Parallel.owner``)
    replaced by :data:`HELD_BY` and the rank that writes it, and every
    DTensor by a copy of its local shard.  The optimizer's state and the
    accumulated gradients are keyed by parameter name (a pipeline stage
    indexes only its own parameters).  Scalars and the generator's state
    stay in every file."""
    import torch.distributed as dist

    mesh, rank = state.model.mesh, dist.get_rank()
    names = _param_names(state)

    def keep(name, t):
        if not torch.is_tensor(t) or t.dim() == 0:
            return t
        owner = mesh.owner(name, t)
        if owner != rank:
            return f"{HELD_BY}{owner}"
        return t.to_local().clone() if hasattr(t, "to_local") else t

    accum = dict(blob["train"]["accum"])
    opt = accum["optimizer"]
    accum["optimizer"] = {
        "state": {names[i]: {k: keep(names[i], v) for k, v in st.items()}
                  for i, st in opt["state"].items()},
        "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                         for g in opt["param_groups"]]}
    if accum["acc"] is not None:
        accum["acc"] = {names[i]: keep(names[i], a) for i, a in enumerate(accum["acc"])}
    return {"model": {n: keep(n, t) for n, t in blob["model"].items()},
            "train": dict(blob["train"], accum=accum), "mesh": dict(mesh.shape)}


def _by_index(train: Dict, names: List[str]) -> Dict:
    """:func:`_write_once`'s name-keyed optimizer state and accumulation
    back in this process's index order."""
    index = {n: i for i, n in enumerate(names)}
    accum = dict(train["accum"])
    opt = accum["optimizer"]
    accum["optimizer"] = {
        "state": {index[n]: st for n, st in opt["state"].items()},
        "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                         for g in opt["param_groups"]]}
    if accum["acc"] is not None:
        accum["acc"] = [accum["acc"][n] for n in names]
    return dict(train, accum=accum)


def save_train_state(path: str, state) -> int:
    """Write the train state of ``state`` (a ``training.step.TrainStep``)
    into the directory ``path`` (``train_state.pt``: the model's state dict
    and ``state.state_dict()``), through a temporary file renamed into
    place.  Returns the bytes written.

    Under a mesh (``state.model.mesh``) each process writes its own file,
    ``train_state.rank<r>.pt``, and each tensor is written once, as Orbax
    writes each array once: a shard (FSDP2's, TP's local tensors, a
    pipeline stage's layers) by the process at coordinate 0 on the axes
    that replicate it, a replicated tensor by rank 0, AdamW's moments with
    their parameter; the file names the rank that holds each tensor it
    leaves out (:func:`_write_once`).  No collective runs.  Chosen over
    ``torch.distributed.checkpoint`` (whose planning runs collectives) and
    over a whole state gathered on rank 0 (every shard through one
    process): the price is that a restore needs the mesh it was written
    on, which it checks, and reads the other ranks' files, so every host
    must see the directory."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, _state_file(state))
    tmp = f"{out}.{os.getpid()}.tmp"
    blob = {"model": state.model.state_dict(), "train": state.state_dict()}
    if state.model.mesh is not None:
        blob = _write_once(blob, state)
    torch.save(blob, tmp)
    os.replace(tmp, out)
    return os.path.getsize(out)


def restore_train_state(path: str, state):
    """Load a :func:`save_train_state` directory into ``state`` (a
    ``TrainStep`` over a model of the same shapes, on the same mesh when
    it was written under one) and its model, in place; each tensor is
    copied into its parameter's dtype and device, a tensor another rank
    wrote read from that rank's file.  Returns ``state``."""
    files: Dict[str, Dict] = {}

    def load(name):
        if name not in files:
            files[name] = torch.load(os.path.join(path, name), map_location="cpu",
                                     weights_only=True, mmap=True)
        return files[name]

    blob = load(_state_file(state))
    mesh = state.model.mesh
    if mesh is None:
        state.model.load_state_dict(blob["model"])
        state.load_state_dict(blob["train"])
        return state
    if blob.get("mesh") != mesh.shape:
        raise ValueError(f"{path} was written on the mesh {blob.get('mesh')}; this run's "
                         f"is {mesh.shape}")

    def fetch(value, keys):
        if isinstance(value, str) and value.startswith(HELD_BY):
            value = load(f"train_state.rank{int(value[len(HELD_BY):])}.pt")
            for k in keys:
                value = value[k]
        return value

    def fill(obj, keys):
        if isinstance(obj, dict):
            return {k: fill(v, keys + (k,)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(fill(v, keys + (i,)) for i, v in enumerate(obj))
        return fetch(obj, keys)

    own = state.model.state_dict()
    if set(own) != set(blob["model"]):
        raise KeyError(f"{path}: the state's keys differ from the model's: "
                       f"{sorted(set(own) ^ set(blob['model']))[:8]}")
    with torch.no_grad():
        for name, target in own.items():
            if name in mesh.freed:
                continue                  # another pipeline stage's layer
            local = target.to_local() if hasattr(target, "to_local") else target
            local.copy_(fetch(blob["model"][name], ("model", name)))
    state.load_state_dict(_by_index(fill(blob["train"], ("train",)), _param_names(state)))
    return state
