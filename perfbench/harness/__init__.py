"""The benchmark's own machinery: loading the cell's files, driving a run,
reading the device trace, and assembling the result line.  Nothing here
imports the program at module level; the driver of a cell does that."""
