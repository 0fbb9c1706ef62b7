// Native keyframe ingest pipeline: threaded image decode + undistort.
//
// The host-side role the reference fills with OpenCV inside its C++ mapper
// (image load, cv::remap undistortion, pyramid prep — reference:
// src/gaussian_mapper.cpp:1340-1420 handleNewKeyframe, include/camera.h
// initUndistortRectifyMapAndMask). Here it is a standalone worker-pool
// library with a C ABI consumed from Python via ctypes: JPEG/PNG decode and
// undistortion run on host threads ahead of the training loop, so the TPU
// never waits on image IO.
//
// Build: see build.sh (links against the system OpenCV 4.6).

#include <condition_variable>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/calib3d.hpp>

namespace {

struct Job {
  int index;
  std::string rgb_path;
  std::string depth_path;  // empty = none
  float depth_scale;
};

struct Frame {
  int index = -1;
  cv::Mat rgb;    // float32 HxWx3 in [0,1]
  cv::Mat depth;  // float32 HxW (meters) or empty
  bool ok = false;
};

struct Loader {
  std::vector<Job> jobs;
  std::deque<Frame> done;
  size_t next_submit = 0;
  size_t next_emit = 0;
  std::mutex mu;
  std::condition_variable cv_done;
  std::vector<std::thread> workers;
  bool stop = false;

  // undistortion
  bool undistort = false;
  cv::Mat map1, map2;

  int width = 0, height = 0;

  // frames completed out of order are parked here until their turn
  std::vector<Frame> parked;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_done.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
  }
};

Frame decode(Loader* L, const Job& job) {
  Frame f;
  f.index = job.index;
  cv::Mat bgr = cv::imread(job.rgb_path, cv::IMREAD_COLOR);
  if (bgr.empty()) return f;
  cv::Mat rgb;
  cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
  if (L->undistort) {
    cv::Mat tmp;
    cv::remap(rgb, tmp, L->map1, L->map2, cv::INTER_LINEAR);
    rgb = tmp;
  }
  rgb.convertTo(f.rgb, CV_32FC3, 1.0 / 255.0);

  if (!job.depth_path.empty()) {
    cv::Mat d = cv::imread(job.depth_path, cv::IMREAD_UNCHANGED);
    if (!d.empty()) {
      cv::Mat df;
      d.convertTo(df, CV_32F, 1.0 / job.depth_scale);
      if (L->undistort) {
        cv::Mat tmp;
        cv::remap(df, tmp, L->map1, L->map2, cv::INTER_NEAREST);
        df = tmp;
      }
      f.depth = df;
    }
  }
  f.ok = true;
  return f;
}

void worker(Loader* L) {
  for (;;) {
    Job job;
    {
      std::lock_guard<std::mutex> lk(L->mu);
      if (L->stop || L->next_submit >= L->jobs.size()) return;
      job = L->jobs[L->next_submit++];
    }
    Frame f = decode(L, job);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->parked.push_back(std::move(f));
    }
    L->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* sg_loader_create(const char** rgb_paths, const char** depth_paths,
                       int n, float depth_scale, int n_threads) {
  auto* L = new Loader();
  L->jobs.reserve(n);
  for (int i = 0; i < n; ++i) {
    Job j;
    j.index = i;
    j.rgb_path = rgb_paths[i];
    j.depth_path = depth_paths && depth_paths[i] ? depth_paths[i] : "";
    j.depth_scale = depth_scale;
    L->jobs.push_back(std::move(j));
  }
  if (n > 0) {
    cv::Mat probe = cv::imread(L->jobs[0].rgb_path, cv::IMREAD_COLOR);
    if (!probe.empty()) {
      L->width = probe.cols;
      L->height = probe.rows;
    }
  }
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(worker, L);
  return L;
}

// Configure undistortion (call before frames are consumed; maps are built
// with cv::initUndistortRectifyMap exactly as the reference camera does).
void sg_loader_set_undistort(void* handle, double fx, double fy, double cx,
                             double cy, const double* dist5) {
  auto* L = static_cast<Loader*>(handle);
  cv::Mat K = (cv::Mat_<double>(3, 3) << fx, 0, cx, 0, fy, cy, 0, 0, 1);
  cv::Mat D(1, 5, CV_64F);
  std::memcpy(D.ptr<double>(), dist5, 5 * sizeof(double));
  cv::initUndistortRectifyMap(K, D, cv::Mat(), K,
                              cv::Size(L->width, L->height), CV_32FC1,
                              L->map1, L->map2);
  L->undistort = true;
}

int sg_loader_dims(void* handle, int* w, int* h) {
  auto* L = static_cast<Loader*>(handle);
  *w = L->width;
  *h = L->height;
  return L->width > 0 ? 0 : -1;
}

// Blocking: next frame in submission order. rgb_out must hold h*w*3 floats;
// depth_out may be null or hold h*w floats. Returns the frame index,
// -1 = exhausted, -2 = decode failure.
int sg_loader_next(void* handle, float* rgb_out, float* depth_out,
                   int* has_depth) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= L->jobs.size()) return -1;
  size_t want = L->next_emit;
  Frame frame;
  for (;;) {
    bool found = false;
    for (size_t i = 0; i < L->parked.size(); ++i) {
      if (static_cast<size_t>(L->parked[i].index) == want) {
        frame = std::move(L->parked[i]);
        L->parked.erase(L->parked.begin() + i);
        found = true;
        break;
      }
    }
    if (found) break;
    if (L->stop) return -1;
    L->cv_done.wait(lk);
  }
  L->next_emit++;
  lk.unlock();

  if (!frame.ok) return -2;
  std::memcpy(rgb_out, frame.rgb.ptr<float>(),
              sizeof(float) * frame.rgb.total() * 3);
  *has_depth = frame.depth.empty() ? 0 : 1;
  if (!frame.depth.empty() && depth_out) {
    std::memcpy(depth_out, frame.depth.ptr<float>(),
                sizeof(float) * frame.depth.total());
  }
  return frame.index;
}

void sg_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
