"""The calls a traffic mix drives, one module a kind of request, found by
the name a mix's ``entry`` gives. Each module has a ``Cell(api, cfg, mix,
seed, device, span)`` whose ``call(i)`` makes request i (the timed path),
``result(i, out)`` brings its answer to the host where the request ends
there (else None), ``record(i, result)`` keeps such an answer for the
check (outside the request's latency), ``units(i)`` counts request i's input
samples, ``kernel_work(i)`` lists the kernels' work of request i, and
``check(kept)`` compares what the timed path produced with the reference
once the window has closed."""
