"""Host-side containers and captures: WAV, SMFF, Matroska, pcap."""
