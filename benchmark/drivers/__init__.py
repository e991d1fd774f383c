"""Entry drivers: ``<entry>.py`` makes a cell's inputs from the seed and
calls the program.  Each holds ``setup(config, traffic, seed, device,
rounded, cache_dir) -> state`` (with ``state["entry"]``, the program's
callable, ``state["work"]``, a request's work by kind, and ``state["calls"]``,
its calls' sizes), ``request(state, i)`` (issues request i, returns before
the device is done), ``finish(state, handle)`` (waits; returns the answer),
``inputs(state, i)`` (request i's exact inputs, for the reference) and
``release(state)`` (drops the program's objects).  ``cache_dir`` is a
fixed directory inside the checkout for what a driver keeps from run to
run, such as a commit cell's SRS."""
