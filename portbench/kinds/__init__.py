"""Configuration kinds: how a configuration file's sizes become the system
under test, its reference outputs and the work one call needs.

A configuration names its kind (``"kind"`` in ``configs/<name>.json``) and
the harness imports ``kinds/<kind>.py``, whose ``build(cfg, seed, device)``
returns an object with:

- ``call(traffic)``: one timed call through the port, returning its result
  as the port returned it (host numpy);
- ``keep(result, traffic, index)``: what of the window's ``index``-th result
  is judged after the window (None: that call is not in the judged sample);
- ``rows(traffic)``: the input rows one call explains;
- ``launches()``: the port's kernel launch counters;
- ``free_program()``: drop the port's objects and device state;
- ``judge(kept, traffic, device)``: ``[(name, value, limit), ...]`` of the
  numbers compared with the plain reference;
- ``control(traffic, device)``: what the reference computed in the next
  precision below the configuration's returns in the port's place;
- ``work(traffic, device)``: the counts (``counts/``) of one call's work.
"""
