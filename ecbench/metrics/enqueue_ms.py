"""enqueue_ms.<op> (the Encoder's host side, host clock): host time inside
`encode_parity_lazy` / `reconstruct_lazy` until it returns, summed over the
untraced calls and divided by their count, in milliseconds."""


def read(rec):
    enq = rec["window"]["enqueue_s"]
    if not enq:
        return None
    return sum(enq) / len(enq) * 1e3
