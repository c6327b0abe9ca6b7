"""Slotted recurrent-state pool (port of `repro/serving/state_pool.py`).

ONE preallocated device tensor per state leaf holds `max_slots`
independent sequences' O(1) states; the model's batch axis is the slot
axis.  Host bookkeeping is a free list: `acquire` takes the lowest free
slot, `release` returns it.  Lane resets on the hot path happen inside the
prefill call (its fresh-slot mask); `read_slot` / `write_slot` /
`reset_slot` serve per-request work and tests.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


class SlotStatePool:
    """Preallocated `max_slots`-wide decode state + free-list admission.
    `max_len` and `dtype` (any float dtype) go to the model's
    `init_slot_state`, as in JAX's pool; the recurrent models ignore
    `max_len` (O(1) state)."""

    def __init__(self, model, max_slots: int, *, max_len: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        self.model = model
        self.max_slots = int(max_slots)
        self.state = model.init_slot_state(self.max_slots, max_len, dtype,
                                           device)
        self._fresh = model.init_slot_state(1, max_len, dtype, device)
        # the slot axis of every leaf (axis 1 of rwkv4's (L, B, D) and of
        # rwkv6's (L, B, D) and (L, B, H, N, N))
        axes = model.decode_state_axes()
        self._axis = {k: ax.index("batch") for k, ax in axes.items()}
        self._free = list(range(self.max_slots - 1, -1, -1))  # pop -> slot 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.max_slots - len(self._free)

    def acquire(self) -> Optional[int]:
        """Claim a free slot (lowest-numbered first), or None if full."""
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._free.append(slot)
        self._free.sort(reverse=True)  # keep pop() -> lowest slot

    def read_slot(self, slot: int) -> Any:
        """Copy slot `slot` out as a batch-1 state tree."""
        return {k: v.narrow(self._axis[k], slot, 1).clone()
                for k, v in self.state.items()}

    def write_slot(self, slot: int, lane_state: Any):
        """Install a batch-1 state tree into slot `slot` (in place)."""
        for k, v in self.state.items():
            v.narrow(self._axis[k], slot, 1).copy_(lane_state[k])

    def reset_slot(self, slot: int):
        """Restore slot `slot` to the fresh (just-initialized) state."""
        self.write_slot(slot, self._fresh)
