"""The benchmark's frozen yardstick for the port's kernels: each kernel's
operations and bytes (one file per kernel, copied from the program's
cost rules as they stood when the benchmark was defined), the card's
peaks, and the shapes at which each cell's engine calls the kernels."""
