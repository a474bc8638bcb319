"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the full 700 W power limit), and the card's
own name and power limit as ``nvidia-smi`` reads them.

A roofline share is stated against these peaks, with the card's power
limit beside it: a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # int8 tensor cores


def _smi(fields: str) -> str | None:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def telemetry() -> str:
    """The first card's SM clock (MHz), temperature (C), power draw (W)
    and active clock-event reasons, as one note; "" without nvidia-smi."""
    return _smi("clocks.sm,temperature.gpu,power.draw,clocks_event_reasons.active") or ""


def power_limit_w() -> float | None:
    """The first card's power limit in watts by ``nvidia-smi``; None where
    the tool is absent or says nothing readable."""
    out = _smi("power.limit")
    try:
        return float(out) if out is not None else None
    except ValueError:
        return None
