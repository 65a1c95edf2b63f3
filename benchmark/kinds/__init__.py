"""The kinds of request a traffic file can name, one module a kind.

Each module `kinds/<kind>.py` gives `setup(prog, cfg, traffic, rng,
device, phase, plant)` (the load, warmed, whose `request(spans)` the
window calls), `judge(load, items, cfg, traffic, seed, device)` (the
numbers compared after the window, and the work the metric readers
count), `control_numbers(cfg, traffic, seed, device)` (the control's
numbers) and `PLANTS` (the faults planted in its timed path).
"""
