// Stand-in for the CUDA runtime header when g++ compiles the device code.
#pragma once
