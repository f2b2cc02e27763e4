"""The port's native GF(2^8) core (csrc/), built with g++ at first use."""
