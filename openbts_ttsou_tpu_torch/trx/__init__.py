"""The transceiver engine, receive half (Transceiver52M/Transceiver.cpp)."""
