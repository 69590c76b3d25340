// dwbc_host: native host-side runtime for the batched WBC framework.
//
// The device computes; the host compiles models, moves bytes, and keeps
// real-time. This library is the C++ counterpart of libdwbc_tpu's host
// layer: URDF -> compiled fixed-topology model arrays, golden-matrix IO,
// and the real-time producer/consumer control-loop harness.
//
// Parity reference: the upstream library's model init
// (/root/reference/src/dwbc.cpp:102-252) builds an RBDL runtime model; here
// compilation is ahead-of-time and the output is a flat array artifact
// consumed by the JAX/XLA pipeline (libdwbc_tpu/model/compile.py documents
// the same layout).
#pragma once

#include <array>
#include <cstdint>
#include <map>
#include <string>
#include <vector>

namespace dwbc_host {

using Mat3 = std::array<double, 9>;  // row-major 3x3
using Vec3 = std::array<double, 3>;

struct CompiledModel {
  std::string name;
  bool floating = true;
  int nbody = 0;      // moving bodies incl. base
  int ndof = 0;       // generalized velocities
  int model_dof = 0;  // actuated joints

  std::vector<std::string> body_names;
  std::vector<std::string> joint_names;
  std::vector<int32_t> parent;    // (nbody), -1 for base
  std::vector<int32_t> q_index;   // (nbody)
  std::vector<Mat3> X_T_rot;      // child joint frame rotation in parent
  std::vector<Vec3> X_T_trans;    // child joint frame origin in parent
  std::vector<Vec3> axis;         // revolute axis, child frame
  std::vector<double> mass;
  std::vector<Vec3> com;          // lumped COM, body frame
  std::vector<Mat3> inertia;      // lumped inertia about COM, body frame
  std::vector<double> joint_limit_lower, joint_limit_upper;
  std::vector<double> effort_limit, velocity_limit, damping;
  // frames merged away by fixed-joint lumping: name -> (body, R, p)
  std::map<std::string, std::tuple<int, Mat3, Vec3>> fixed_frames;

  double total_mass = 0.0;

  // Serialize to the flat .dwbcm binary format (see model_io.cpp for the
  // layout); readable from Python via libdwbc_tpu.model.native_io.
  bool save(const std::string& path) const;
  static bool load(const std::string& path, CompiledModel* out);
};

// Compile a URDF file into a CompiledModel. Returns false + message on error.
// Ordering parity: pre-order DFS with child joints sorted alphabetically by
// joint name (matches urdfdom's std::map iteration + RBDL's reader, so body
// numbering and q layout are identical to the reference).
bool compile_urdf(const std::string& urdf_path, bool floating,
                  CompiledModel* out, std::string* error);

}  // namespace dwbc_host
