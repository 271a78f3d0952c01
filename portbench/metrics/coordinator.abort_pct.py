"""Certification aborts at the coordinator as a share of the attempts
the clients made in the window (``antidote_aborted_transactions_total``,
as a delta over the window; a retried transaction is one attempt a
try)."""


def read(ctx):
    lay = ctx["layer"]
    if "counters" not in lay or not lay.get("attempts"):
        return None
    return 100.0 * lay["counters"]["aborts"] / lay["attempts"]
