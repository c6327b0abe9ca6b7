"""Slotted recurrent-state pool (port of `repro/serving/state_pool.py`).

ONE preallocated device tensor per state leaf holds `max_slots`
independent sequences' O(1) states; the model's batch axis is the slot
axis.  Host bookkeeping is a free list: `acquire` takes the lowest free
slot, `release` returns it.  Lane resets on the hot path happen inside the
prefill call (its fresh-slot mask); `read_slot` / `write_slot` /
`reset_slot` serve per-request work (the prefix cache's capture and
install) and tests.  `lane_finite` is the NaN/Inf sentinel's one sweep
over the pool, `poison_slot` the `corrupt_state_leaf` fault drill's.

The pool is written in place (`write_slot`), between ticks too, so a
reader that must see the pool as it was at a tick boundary (a snapshot)
takes its own copy.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
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
        """Install a batch-1 state tree into slot `slot` (in place; the
        programs' outputs are inference tensors, written in that mode)."""
        with torch.inference_mode():
            for k, v in self.state.items():
                v.narrow(self._axis[k], slot, 1).copy_(lane_state[k])

    def reset_slot(self, slot: int):
        """Restore slot `slot` to the fresh (just-initialized) state."""
        self.write_slot(slot, self._fresh)

    def lane_finite(self) -> Optional[np.ndarray]:
        """The NaN/Inf sentinel: a (max_slots,) bool numpy array, True
        where every floating state element of that lane is finite; None
        when no leaf is floating.  One reduction per leaf on the pool's
        device, combined there, and one host read for the sweep."""
        ok = None
        for k, v in self.state.items():
            if not v.is_floating_point():
                continue
            ax = self._axis[k]
            lane = torch.isfinite(v).movedim(ax, 0).reshape(
                v.shape[ax], -1).all(dim=1)
            ok = lane if ok is None else ok & lane
        return None if ok is None else ok.cpu().numpy()

    def poison_slot(self, slot: int, value: float = float("nan")):
        """Overwrite every floating leaf of lane `slot` with `value` (the
        `corrupt_state_leaf` fault drill); integer leaves stay."""
        lane = {k: torch.full_like(v, value) if v.is_floating_point()
                else v for k, v in self.read_slot(slot).items()}
        self.write_slot(slot, lane)

    def sync(self):
        """Wait for the pool's pending device work (the scheduler times a
        cache install's copy with it)."""
        dev = next(iter(self.state.values())).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
