"""What one served request of a granite-4.0-h configuration needs, counted
from the configuration's published keys alone (no program is imported).

A request is the configuration's ``input``: a prompt of ``shape[-1]``
tokens and ``new_tokens`` greedy tokens, served as the port serves it: one
prefill of the prompt that gives the first token (the head at its last
position only), then one decode step a further token at positions
``prompt .. prompt + new_tokens - 2``.

MACs of a token in a layer: the mixer's projections (Mamba-2: the
in-projection to z, x, B, C and dt, the conv, the state's update and
read-out, the out-projection; attention: q, k, v, o, and the scores and
values over the keys the token sees), the router, the routed experts
(``num_experts_per_tok`` of them) and the shared expert; the head is
``hidden_size x vocab_size`` a logit row.  The embedding lookup does
none.

The need of a phase is max(bytes / HBM bytes/s, 2 x MACs / peak), the
peak the configuration's precision names:

* the prefill reads every weight once (a prompt of a thousand tokens
  routes pairs to every expert), the prompt's embedding rows, and writes
  its caches (attention's K and V, each Mamba-2 layer's state and conv
  window);
* a decode step reads every weight but the experts no pair of its token
  went to (``num_experts_per_tok`` a layer read, not all), an embedding
  row, the KV cache up to its position (and writes its own), and reads
  and writes each Mamba-2 state and conv window.

Weights count at the configuration's dtype, the router (float32 in the
port) at 4 bytes; states at 4 bytes.
"""

from __future__ import annotations

__all__ = ["macs_of", "need_s_of", "parameters", "phases"]

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
STATE_BYTES = 4


def _dims(c: dict) -> dict:
    d, nh = c["hidden_size"], c["num_attention_heads"]
    H, P, N = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    return {"d": d, "nh": nh, "nkv": c["num_key_value_heads"], "hd": d // nh, "H": H, "P": P, "N": N,
            "d_in": H * P, "k": c["mamba_d_conv"], "E": c["num_local_experts"], "K": c["num_experts_per_tok"],
            "f": c["intermediate_size"], "fs": c["shared_intermediate_size"], "V": c["vocab_size"]}


def parameters(config: dict) -> dict[str, int]:
    """Parameters by part: one Mamba-2 mixer, one attention mixer, one
    MoE's routed experts, its shared expert and router, the norms of a
    layer, the embedding (tied), and the whole."""
    m = _dims(config)
    d, d_in, N, H = m["d"], m["d_in"], m["N"], m["H"]
    conv_ch = d_in + 2 * N
    part = {
        "mamba": d * (2 * d_in + 2 * N + H) + (m["k"] + 1) * conv_ch + 3 * H + d_in + d_in * d,
        "attention": d * m["nh"] * m["hd"] * 2 + 2 * d * m["nkv"] * m["hd"],
        "experts": m["E"] * 3 * d * m["f"],
        "shared": 3 * d * m["fs"],
        "router": d * m["E"],
        "norms": 2 * d,
        "embed": m["V"] * d,
    }
    per_layer = {t: part[t] + part["experts"] + part["shared"] + part["router"] + part["norms"]
                 for t in ("mamba", "attention")}
    part["total"] = part["embed"] + d + sum(per_layer[t] for t in config["layer_types"])
    return part


def _token_macs(m: dict, kind: str, keys: int) -> int:
    """MACs of one token through one layer, seeing ``keys`` keys if it attends."""
    d = m["d"]
    moe = d * m["E"] + m["K"] * 3 * d * m["f"] + 3 * d * m["fs"]
    if kind == "mamba":
        conv_ch = m["d_in"] + 2 * m["N"]
        mixer = d * (m["d_in"] + conv_ch + m["H"]) + m["k"] * conv_ch + 2 * m["H"] * m["P"] * m["N"] + m["d_in"] * d
    else:
        mixer = 2 * d * m["nh"] * m["hd"] + 2 * d * m["nkv"] * m["hd"] + 2 * m["nh"] * m["hd"] * keys
    return mixer + moe


def phases(config: dict) -> list[dict]:
    """MACs and bytes of the prefill and of each decode step of one request."""
    m = _dims(config)
    w = DTYPE_BYTES[config["precision"]["dtype"]]
    T, new = config["input"]["shape"][-1], config["input"]["new_tokens"]
    types = config["layer_types"]
    par = parameters(config)
    n_mamba, n_attn = types.count("mamba"), types.count("attention")
    weights = (par["total"] - len(types) * par["router"]) * w + len(types) * par["router"] * 4
    unread = len(types) * (m["E"] - m["K"]) * 3 * m["d"] * m["f"] * w  # experts a decode step's token skips
    kv_row = 2 * m["nkv"] * m["hd"] * w  # K and V of one position in one layer
    state = m["H"] * m["P"] * m["N"] * STATE_BYTES + (m["k"] - 1) * (m["d_in"] + 2 * m["N"]) * w
    head = m["d"] * m["V"]

    prefill_macs = head + sum(_token_macs(m, kind, t + 1) for kind in types for t in range(T))
    out = [{"phase": "prefill", "macs": prefill_macs,
            "bytes": weights + T * m["d"] * w + n_attn * T * kv_row + n_mamba * state}]
    for pos in range(T, T + new - 1):
        out.append({"phase": "decode", "macs": head + sum(_token_macs(m, kind, pos + 1) for kind in types),
                    "bytes": weights - unread + m["d"] * w + n_attn * (pos + 1) * kv_row + 2 * n_mamba * state})
    return out


def macs_of(config: dict) -> int:
    """MACs of one request: the prefill and every decode step."""
    return sum(p["macs"] for p in phases(config))


def need_s_of(config: dict, rows: int, peaks: dict) -> float:
    """The least device seconds of ``rows`` requests, served one after the
    other: each phase at max(bytes / HBM bytes/s, 2 x MACs / peak)."""
    peak, bw = peaks[config["precision"]["peak"]], peaks["hbm_bytes_s"]
    return rows * sum(max(p["bytes"] / bw, 2 * p["macs"] / peak) for p in phases(config))
