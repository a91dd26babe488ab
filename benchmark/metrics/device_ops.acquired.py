"""``device_ops.acquired``: device operations (kernels, copies, fills) that
``psk/mc_dpsk.decode_chirp_batch`` puts on the card a batch: the device
events of the profiled stretch with the host beside it whose launching
call (matched by its correlation id) lies in the harness's "rx" span, over
that stretch's steps.  The receive chain's enqueue work, one launch
each; the draws, TX, channel and tally are not counted."""


def read(trace):
    if trace.path != "acquired" or trace.host_steps <= 0:
        return None
    n = sum(1 for span in trace.launched_in if span == "rx")
    return n / trace.host_steps if n else None
