"""The price of disaggregated prefill (the handoff rows of
`dalle_pytorch_tpu/observability/comms.py`; the rest of that module, the
training step's comms ledger, comes with ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

from typing import Any, Dict, Optional

from dalle_pytorch_tpu_torch.quantization import kv_bytes_per_elem


def prefill_handoff_bytes(tcfg: Any, n_pre: int, lanes: int = 1, itemsize: int = 4,
                          kv_quant: Optional[str] = None) -> float:
    """Bytes of one admission's prefill -> decode handoff: every layer's k
    and v prefix, `lanes` sequences (a guided request hands over its [cond]
    and [null] prefixes); an int8 handoff at `kv_bytes_per_elem`'s price."""
    return 2.0 * tcfg.depth * lanes * tcfg.heads * n_pre * tcfg.dim_head * kv_bytes_per_elem(
        kv_quant, itemsize, tcfg.dim_head)


def prefill_handoff_row(tcfg: Any, n_pre: int, lanes: int = 1, itemsize: int = 4, ring_bytes: float = 0.0,
                        admissions_per_step: float = 1.0, kv_quant: Optional[str] = None) -> Dict[str, Any]:
    """The comms row of disaggregation: the bytes a prefill worker hands a
    decode replica per admission, the KV prefix and the token-shift ring
    tails, in the shape of the JAX step ledger's rows."""
    payload = prefill_handoff_bytes(tcfg, n_pre, lanes, itemsize, kv_quant=kv_quant)
    row = {"axis": "handoff", "size": 2, "op": "prefill_to_decode",
           "bytes_per_step": (payload + ring_bytes) * admissions_per_step, "payload_bytes": payload,
           "ring_bytes": ring_bytes, "n_pre": n_pre, "lanes": lanes}
    if kv_quant:
        row["kv_quant"] = kv_quant
    return row
