"""Concurrency markers read by rtlint (and by humans).

``@off_loop(lock="_ref_lock")`` declares that a method is a thread
entry point — it runs on CALLER threads, off the owner event loop (the
put path, the striped-arena client methods) — and names the
instance lock its shared-state mutations must hold. The decorator is a
pure annotation: zero runtime cost, the function is returned unchanged
with ``__rt_off_loop__`` attached for introspection. rtlint's RT003
reads the marker statically and flags any ``self.*`` store in the body
that is not inside ``with self.<lock>:`` — intentional GIL-atomic
publishes carry an inline ``# rtlint: disable=RT003 — <why>`` so the
atomicity argument lives next to the code.

This is the static sibling of ``util/sanitizers.SingleLoopChecker``
(which pins loop-owned components at runtime); together they are this
repo's analog of the reference's ``thread_checker.h`` + tsan CI tier.

Kept dependency-free: imported by ``object_store.py``/``worker.py``
before anything heavy is loadable.
"""

from __future__ import annotations

from typing import Callable, Optional


def off_loop(lock: Optional[str] = None) -> Callable:
    """Mark a method as an off-event-loop thread entry; ``lock`` names
    the instance attribute (e.g. ``"_ref_lock"``) guarding its shared
    mutations. Use as ``@off_loop(lock="_ref_lock")`` (the call form is
    required — rtlint keys on it)."""
    def deco(fn):
        fn.__rt_off_loop__ = {"lock": lock}
        return fn
    return deco
