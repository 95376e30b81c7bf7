"""The program's entries that traffic mixes drive, one file each, found by
the name a traffic file gives under "entry".  Each has load() (the
program's callable (a, b) -> output tensor), expect(ref, pool, inst) (the
reference's output and what else it worked out) and control() (the
reference computed one step below what the configuration states).  An
entry whose call is more than that callable on a resident instance also
has program(pool, device, traffic, spans_on): an object with run(j) (the
pool's j-th draw -> the output in host memory), close() and spans, as
benchmark.harness.Program is."""
