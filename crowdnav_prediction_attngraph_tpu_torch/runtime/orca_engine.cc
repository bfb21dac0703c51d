// Native ORCA crowd engine (C++).
//
// Host-side counterpart of env/orca.py implementing the same published ORCA
// algorithm (van den Berg et al., ISRR 2009): per-agent half-plane
// construction + incremental 2D linear program with infeasibility projection.
// The reference framework's only native dependency was the external RVO2
// library behind `import rvo2` (reference crowd_nav/policy/orca.py:64-117);
// this file makes the TPU framework self-contained: it serves as an
// independent numerical oracle for the JAX kernel and as a fast host crowd
// stepper for dataset generation when no accelerator is attached.
//
// Build: g++ -O2 -shared -fPIC -o liborca_engine.so orca_engine.cc
// Python binding: ctypes (runtime/native.py).

#include <cmath>
#include <cstddef>
#include <vector>

namespace {

constexpr double kEps = 1e-5;

struct Vec2 {
  double x = 0.0, y = 0.0;
  Vec2() = default;
  Vec2(double x_, double y_) : x(x_), y(y_) {}
  Vec2 operator+(const Vec2& o) const { return {x + o.x, y + o.y}; }
  Vec2 operator-(const Vec2& o) const { return {x - o.x, y - o.y}; }
  Vec2 operator*(double s) const { return {x * s, y * s}; }
  Vec2 operator-() const { return {-x, -y}; }
};

double dot(const Vec2& a, const Vec2& b) { return a.x * b.x + a.y * b.y; }
double det(const Vec2& a, const Vec2& b) { return a.x * b.y - a.y * b.x; }
double absSq(const Vec2& a) { return dot(a, a); }
double norm(const Vec2& a) { return std::sqrt(absSq(a)); }
Vec2 normalize(const Vec2& a) {
  double n = norm(a);
  return n > 0 ? Vec2{a.x / n, a.y / n} : Vec2{0, 0};
}

struct Line {
  Vec2 point;
  Vec2 direction;
};

bool linearProgram1(const std::vector<Line>& lines, size_t lineNo,
                    double radius, const Vec2& optVelocity, bool directionOpt,
                    Vec2* result) {
  const double dotProduct = dot(lines[lineNo].point, lines[lineNo].direction);
  const double discriminant =
      dotProduct * dotProduct + radius * radius - absSq(lines[lineNo].point);
  if (discriminant < 0.0) return false;

  const double sqrtDiscriminant = std::sqrt(discriminant);
  double tLeft = -dotProduct - sqrtDiscriminant;
  double tRight = -dotProduct + sqrtDiscriminant;

  for (size_t i = 0; i < lineNo; ++i) {
    const double denominator = det(lines[lineNo].direction, lines[i].direction);
    const double numerator =
        det(lines[i].direction, lines[lineNo].point - lines[i].point);
    if (std::fabs(denominator) <= kEps) {
      if (numerator < 0.0) return false;
      continue;
    }
    const double t = numerator / denominator;
    if (denominator >= 0.0) {
      tRight = std::min(tRight, t);
    } else {
      tLeft = std::max(tLeft, t);
    }
    if (tLeft > tRight) return false;
  }

  double t;
  if (directionOpt) {
    t = dot(optVelocity, lines[lineNo].direction) > 0.0 ? tRight : tLeft;
  } else {
    t = dot(lines[lineNo].direction, optVelocity - lines[lineNo].point);
    t = std::min(std::max(t, tLeft), tRight);
  }
  *result = lines[lineNo].point + lines[lineNo].direction * t;
  return true;
}

size_t linearProgram2(const std::vector<Line>& lines, double radius,
                      const Vec2& optVelocity, bool directionOpt,
                      Vec2* result) {
  if (directionOpt) {
    *result = optVelocity * radius;
  } else if (absSq(optVelocity) > radius * radius) {
    *result = normalize(optVelocity) * radius;
  } else {
    *result = optVelocity;
  }
  for (size_t i = 0; i < lines.size(); ++i) {
    if (det(lines[i].direction, lines[i].point - *result) > 0.0) {
      const Vec2 tempResult = *result;
      if (!linearProgram1(lines, i, radius, optVelocity, directionOpt,
                          result)) {
        *result = tempResult;
        return i;
      }
    }
  }
  return lines.size();
}

void linearProgram3(const std::vector<Line>& lines, size_t beginLine,
                    double radius, Vec2* result) {
  double distance = 0.0;
  for (size_t i = beginLine; i < lines.size(); ++i) {
    if (det(lines[i].direction, lines[i].point - *result) > distance) {
      std::vector<Line> projLines;
      for (size_t j = 0; j < i; ++j) {
        Line line;
        const double determinant =
            det(lines[i].direction, lines[j].direction);
        if (std::fabs(determinant) <= kEps) {
          if (dot(lines[i].direction, lines[j].direction) > 0.0) continue;
          line.point = (lines[i].point + lines[j].point) * 0.5;
        } else {
          line.point =
              lines[i].point +
              lines[i].direction *
                  (det(lines[j].direction, lines[i].point - lines[j].point) /
                   determinant);
        }
        line.direction = normalize(lines[j].direction - lines[i].direction);
        projLines.push_back(line);
      }
      const Vec2 tempResult = *result;
      if (linearProgram2(projLines, radius,
                         Vec2{-lines[i].direction.y, lines[i].direction.x},
                         true, result) < projLines.size()) {
        *result = tempResult;
      }
      distance = det(lines[i].direction, lines[i].point - *result);
    }
  }
}

Vec2 orcaVelocity(const Vec2& egoPos, const Vec2& egoVel, double egoRadius,
                  double maxSpeed, const Vec2& prefVel, const double* nbrPos,
                  const double* nbrVel, const double* nbrRadius,
                  const unsigned char* nbrMask, int numNbrs, double timeStep,
                  double timeHorizon, double neighborDist) {
  const double invTimeHorizon = 1.0 / timeHorizon;
  const double invTimeStep = 1.0 / timeStep;
  std::vector<Line> lines;
  lines.reserve(numNbrs);

  for (int j = 0; j < numNbrs; ++j) {
    if (!nbrMask[j]) continue;
    const Vec2 otherPos(nbrPos[2 * j], nbrPos[2 * j + 1]);
    const Vec2 relativePosition = otherPos - egoPos;
    if (absSq(relativePosition) >= neighborDist * neighborDist) continue;
    const Vec2 otherVel(nbrVel[2 * j], nbrVel[2 * j + 1]);
    const Vec2 relativeVelocity = egoVel - otherVel;
    const double distSq = absSq(relativePosition);
    const double combinedRadius = egoRadius + nbrRadius[j];
    const double combinedRadiusSq = combinedRadius * combinedRadius;

    Line line;
    Vec2 u;
    if (distSq > combinedRadiusSq) {
      const Vec2 w = relativeVelocity - relativePosition * invTimeHorizon;
      const double wLengthSq = absSq(w);
      const double dotProduct1 = dot(w, relativePosition);
      if (dotProduct1 < 0.0 &&
          dotProduct1 * dotProduct1 > combinedRadiusSq * wLengthSq) {
        const double wLength = std::sqrt(wLengthSq);
        const Vec2 unitW = w * (1.0 / wLength);
        line.direction = Vec2{unitW.y, -unitW.x};
        u = unitW * (combinedRadius * invTimeHorizon - wLength);
      } else {
        const double leg = std::sqrt(distSq - combinedRadiusSq);
        if (det(relativePosition, w) > 0.0) {
          line.direction = Vec2{relativePosition.x * leg -
                                    relativePosition.y * combinedRadius,
                                relativePosition.x * combinedRadius +
                                    relativePosition.y * leg} *
                           (1.0 / distSq);
        } else {
          line.direction = -(Vec2{relativePosition.x * leg +
                                      relativePosition.y * combinedRadius,
                                  -relativePosition.x * combinedRadius +
                                      relativePosition.y * leg} *
                             (1.0 / distSq));
        }
        const double dotProduct2 = dot(relativeVelocity, line.direction);
        u = line.direction * dotProduct2 - relativeVelocity;
      }
    } else {
      const Vec2 w = relativeVelocity - relativePosition * invTimeStep;
      const double wLength = norm(w);
      const Vec2 unitW = w * (1.0 / wLength);
      line.direction = Vec2{unitW.y, -unitW.x};
      u = unitW * (combinedRadius * invTimeStep - wLength);
    }
    line.point = egoVel + u * 0.5;
    lines.push_back(line);
  }

  Vec2 result;
  const size_t lineFail =
      linearProgram2(lines, maxSpeed, prefVel, false, &result);
  if (lineFail < lines.size()) {
    linearProgram3(lines, lineFail, maxSpeed, &result);
  }
  return result;
}

}  // namespace

extern "C" {

// Single-ego query: mirrors env/orca.py::orca_velocity.
void orca_velocity(const double* ego_pos, const double* ego_vel,
                   double ego_radius, double max_speed, const double* pref_vel,
                   const double* nbr_pos, const double* nbr_vel,
                   const double* nbr_radius, const unsigned char* nbr_mask,
                   int num_nbrs, double time_step, double time_horizon,
                   double neighbor_dist, double* out_vel) {
  const Vec2 v = orcaVelocity(
      Vec2(ego_pos[0], ego_pos[1]), Vec2(ego_vel[0], ego_vel[1]), ego_radius,
      max_speed, Vec2(pref_vel[0], pref_vel[1]), nbr_pos, nbr_vel, nbr_radius,
      nbr_mask, num_nbrs, time_step, time_horizon, neighbor_dist);
  out_vel[0] = v.x;
  out_vel[1] = v.y;
}

// Crowd step: every agent computes its ORCA velocity against all the others
// (the reference's per-human simulator pattern, orca.py:64-117: pref velocity
// toward goal, unit-clipped; ego max speed = its v_pref) and integrates.
void orca_crowd_step(int num_agents, double* pos, double* vel,
                     const double* radius, const double* v_pref,
                     const double* goal, double safety_space, double time_step,
                     double time_horizon, double neighbor_dist) {
  std::vector<double> newVel(2 * num_agents);
  std::vector<double> inflated(num_agents);
  for (int i = 0; i < num_agents; ++i)
    inflated[i] = radius[i] + 0.01 + safety_space;

  std::vector<unsigned char> mask(num_agents);
  for (int i = 0; i < num_agents; ++i) {
    for (int j = 0; j < num_agents; ++j) mask[j] = j != i;
    Vec2 goalVec = Vec2(goal[2 * i], goal[2 * i + 1]) -
                   Vec2(pos[2 * i], pos[2 * i + 1]);
    const double speed = norm(goalVec);
    const Vec2 prefVel = speed > 1.0 ? goalVec * (1.0 / speed) : goalVec;
    const Vec2 v = orcaVelocity(
        Vec2(pos[2 * i], pos[2 * i + 1]), Vec2(vel[2 * i], vel[2 * i + 1]),
        inflated[i], v_pref[i], prefVel, pos, vel, inflated.data(),
        mask.data(), num_agents, time_step, time_horizon, neighbor_dist);
    newVel[2 * i] = v.x;
    newVel[2 * i + 1] = v.y;
  }
  for (int i = 0; i < 2 * num_agents; ++i) {
    vel[i] = newVel[i];
    pos[i] += newVel[i] * time_step;
  }
}

}  // extern "C"
