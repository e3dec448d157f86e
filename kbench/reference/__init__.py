"""The plain reference the benchmark judges the program by: CRC32C,
LZ4 frames, v2 RecordBatches, and the oracle over a topic's logs.
It imports nothing of the program under test."""
