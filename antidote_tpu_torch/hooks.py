"""Commit hooks — per-bucket pre/post commit callbacks.

Mirrors the reference's antidote_hooks (reference
src/antidote_hooks.erl:29-53, 92-164): a pre-commit hook runs at update
time and may transform the operation or fail the transaction; a
post-commit hook runs after commit and its failures are only logged.

Hook signature: ``hook(key, type_name, op) -> (key, type_name, op)``
for pre-commit (return a possibly transformed triple, raise to abort);
post-commit hooks take the same arguments and their return value is
ignored.  Hooks are selected by the bucket they were registered under
(the reference passes {Key, Bucket} as one tuple; here the bucket is
implicit in the registration).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Tuple

logger = logging.getLogger(__name__)

Hook = Callable[[Any, str, Tuple], Tuple]


class HookRegistry:
    def __init__(self):
        self._pre: Dict[Any, Hook] = {}
        self._post: Dict[Any, Hook] = {}

    def register_pre_hook(self, bucket, hook: Hook) -> None:
        self._pre[bucket] = hook

    def register_post_hook(self, bucket, hook: Hook) -> None:
        self._post[bucket] = hook

    def unregister_hook(self, which: str, bucket) -> None:
        {"pre_commit": self._pre, "post_commit": self._post}[which].pop(
            bucket, None)

    def get_hooks(self, which: str, bucket):
        return {"pre_commit": self._pre, "post_commit": self._post}[
            which].get(bucket)

    def run_pre(self, bucket, key, type_name: str, op: Tuple):
        """Apply the pre-commit hook; exceptions abort the transaction
        (reference: failing pre-hook => update rejected)."""
        hook = self._pre.get(bucket)
        if hook is None:
            return key, type_name, op
        return hook(key, type_name, op)

    def run_post(self, bucket, key, type_name: str, op: Tuple) -> None:
        """Apply the post-commit hook; failures are logged, never raised
        (reference: post-hook errors don't fail the txn)."""
        hook = self._post.get(bucket)
        if hook is None:
            return
        try:
            hook(key, type_name, op)
        except Exception:
            logger.exception("post-commit hook failed for bucket %r", bucket)
