"""The benchmark's harness: finding a cell's pieces by name, the timed
window, the trace's reading, the generator and the H100's peaks."""
