"""The loops that drive a traffic mix's window, one file each, found by the
name a traffic file gives under "loop" (default "closed").  Each has
drive(program, take, seconds, tracer, clients, device) -> (records, t0, t1)."""
