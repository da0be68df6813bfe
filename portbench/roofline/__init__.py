"""Each kernel's bytes and operations, counted from the shapes the
configuration fixes (never from what a launch did): one module a kernel,
with ``least(config, peaks)`` giving the least time of one launch and the
bound that sets it.  Each input byte is read once and each output byte
written once."""
